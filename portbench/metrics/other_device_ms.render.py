"""Device ms a frame outside the MLP kernels: rays, sampling, the IPE,
compositing, quantisation and the copies."""

from portbench import layer


def read(run):
    return layer.other_device_ms(run, "render")
