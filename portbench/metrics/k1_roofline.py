"""k1_roofline: K1's share of its roofline (%): the least time the
profiled queue's pileups need at the card's published HBM bandwidth,
over the device time of the pileup kernels in that queue's trace.  The
least time is counted from the jobs' own sizes
(``harness/roofline.k1_bytes``), so it does not move when a change
merges, splits or replaces launches."""

from portbench.harness import roofline

#: the pileup kernels, by the name the trace gives them
KERNELS = ("pileup_rows_kernel",)


def read(w):
    p = w.profile
    if p is None:
        return None
    secs = p.kernel_seconds(KERNELS)
    jobs = [j for j in p.jobs if j.ok
            and j.extra.get("pileup_path") == "device"]
    if secs <= 0 or not jobs:
        return None
    nbytes = 0
    for j in jobs:
        s = w.samples[j.sample]
        nbytes += roofline.k1_bytes(s.pileup_events, s.n_reads, s.cigar_ops,
                                    s.contig_len)
    return 100.0 * roofline.bound_seconds(nbytes) / secs
