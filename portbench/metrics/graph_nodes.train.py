"""Device operations (kernel, memcpy and memset nodes) in one training
step's CUDA graph: the program's counter ``graph.nodes``, which
``train/step.py::CapturedTrainStep`` sets to the node count of the graph it
replayed last, counted once at the capture.  None where no graph was
captured (an eager run) or the program keeps no such counter."""


def read(run):
    if run.kind != "train":
        return None
    from ddnerf_tpu_torch.utils import profiling

    counter = getattr(profiling, "counter", None)
    nodes = counter("graph.nodes") if counter is not None else None
    return None if nodes is None else float(nodes)
