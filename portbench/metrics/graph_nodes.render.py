"""Device operations (kernel, memcpy and memset nodes) one frame replays
from the renderer's CUDA graphs: the program's counter
``render.graph_nodes``, which ``render/graphs.py::ChunkGraphs`` sets at
every capture to the weight pack's graph plus each of the frame's chunk
graphs.  None on a training run, where no render graph was captured, or
where the program keeps no such counter."""


def read(run):
    if run.kind != "render":
        return None
    from ddnerf_tpu_torch.utils import profiling

    counter = getattr(profiling, "counter", None)
    nodes = counter("render.graph_nodes") if counter is not None else None
    return None if nodes is None else float(nodes)
