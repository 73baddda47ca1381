"""CUDA graphs captured in the window, in the engine and every sub-engine
(the port's process-wide capture counts, read before and after the
window). None where the run does not count them."""


def read(run):
    return getattr(run, "captures", None)
