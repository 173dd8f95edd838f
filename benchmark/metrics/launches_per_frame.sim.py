"""Kernel-launch runtime calls of the profiled slice per frame (a graph
launch counts once)."""


def read(r):
    sl = getattr(r, "slice", None)
    if r.kind != "sim" or not sl or not sl["frames"] or not sl["launches"]:
        return None
    return sl["launches"] / sl["frames"]
