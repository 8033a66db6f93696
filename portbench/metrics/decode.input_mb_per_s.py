"""decode.input_mb_per_s: the input files' bytes over the jobs' decode
seconds (``phase/decode_sec`` of each job's registry: the decode-ahead
thread's and the job's own)."""


def read(w):
    secs = sum(j.decode_sec for j in w.jobs if j.ok)
    if secs <= 0:
        return None
    nbytes = sum(w.samples[j.sample].file_bytes for j in w.jobs if j.ok)
    return nbytes / secs / 1e6
