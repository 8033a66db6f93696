"""fasta.write_s_per_job: the FASTA files' write (the port's
``fasta_write`` span), in seconds a job of the profiled queue: the span's
``user_annotation`` events in the device trace, summed."""

SPAN = "fasta_write"


def read(w):
    p = w.profile
    if p is None or not p.jobs:
        return None
    durs = [e["dur"] for e in p.events
            if e.get("cat") == "user_annotation" and e.get("name") == SPAN]
    return sum(durs) / 1e6 / len(p.jobs) if durs else None
