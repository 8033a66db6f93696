"""tail.s_per_job: the mean of ``stats.extra["tail_sec"]`` (the vote and
the insertion tail, on the card or the host; ends in its fetch)."""


def read(w):
    v = [j.extra["tail_sec"] for j in w.jobs
         if j.ok and j.extra.get("tail_sec") is not None]
    return sum(v) / len(v) if v else None
