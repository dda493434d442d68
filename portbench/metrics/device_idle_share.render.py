"""The device's idle share of the traced stretch, in %: one minus the union of
its activity intervals over the stretch's wall, both from the profiler's trace."""

from portbench import layer


def read(run):
    return layer.idle_share(run, "render")
