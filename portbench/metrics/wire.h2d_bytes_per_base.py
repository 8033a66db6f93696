"""wire.h2d_bytes_per_base: bytes the staging shipped to the card
(``stats.extra["h2d_bytes"]``) over the aligned read bases of the jobs
that counted on the card.  A count: it repeats exactly."""


def read(w):
    jobs = [j for j in w.jobs if j.ok and j.extra.get("pileup_path")
            == "device" and j.extra.get("h2d_bytes") is not None]
    bases = sum(w.samples[j.sample].aligned_bases for j in jobs)
    if not jobs or bases == 0:
        return None
    return sum(j.extra["h2d_bytes"] for j in jobs) / bases
