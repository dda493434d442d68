"""The whole frame's MLP operations (from the shapes, whatever runs them)
over the window's wall time and the card's bf16 peak, in %."""

from portbench import layer


def read(run):
    return layer.mfu(run, "render")
