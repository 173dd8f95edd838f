"""Mean seconds of ``loss.backward()`` per step of the traced run's
window, by CUDA events around it."""


def read(r):
    if r.kind != "train" or not r.backward_s:
        return None
    return sum(r.backward_s) / len(r.backward_s)
