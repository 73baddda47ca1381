"""The kubelet's self time per gang bound, ms: kubelet.* spans of the
window (the tick, its heartbeat sweep, the pod points) less child spans
and their store charges, over the gangs bound in the window."""

from benchmark.spans import KUBELET, family_ms_per_gang


def read(run):
    return family_ms_per_gang(run, KUBELET, "kubelet.tick")
