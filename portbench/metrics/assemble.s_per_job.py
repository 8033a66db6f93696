"""assemble.s_per_job: the mean of ``stats.extra["assemble_sec"]`` (the
host's render of the FASTA records)."""


def read(w):
    v = [j.extra["assemble_sec"] for j in w.jobs
         if j.ok and j.extra.get("assemble_sec") is not None]
    return sum(v) / len(v) if v else None
