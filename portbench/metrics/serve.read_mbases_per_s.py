"""serve.read_mbases_per_s: the aligned read bases of the window's jobs
outside the profiled queue over the time those queues took, on the
host's clock (Mbases/s): what a lab's closed loop of queues gets."""


def read(w):
    if w.unprofiled_s <= 0 or not w.jobs:
        return None
    bases = sum(w.samples[j.sample].aligned_bases for j in w.jobs)
    return bases / w.unprofiled_s / 1e6
