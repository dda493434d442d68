"""A frame's chunks as replayed CUDA graphs: the single-device CUDA path of
``render/renderer.py::ImageRenderer.render_flat`` in ``mode="render"``
(video frames and eval images).

A chunk's device work (``RayBatch.create``, ``pipeline.render_rays`` and
the maps asked for) is recorded once per :class:`GraphKey` into a
``torch.cuda.CUDAGraph`` and replayed for every chunk of that shape: an
800×800 frame in chunks of 16,384 rays is 39 replays of one graph and one
of the ragged 1,024-ray tail's, where it was ≈ 185 eager launches a chunk.
For each chunk the host copies the rays into the graph's static inputs,
replays it and clones the maps it wrote, which the renderer then
concatenates as it does the eager chunks'.

What a replay reads that could change between frames is fed in, never
frozen at the capture:

* the weights, in place: a graph of their own packs them for the fused
  kernels (``kernels/fused_mlp.py::pack_weights``) into buffers the chunk
  graphs read (captured under ``fused_mlp.held_packs``), replayed once at
  the start of every frame.  Parameters whose storage moved (a
  ``load_state_dict(..., assign=True)``, a resume into new tensors) drop
  every graph, and the frame captures them anew;
* ``gaussian_smooth_factor``, as a 0-d device tensor filled every frame;
* the random draws, where the validation settings draw (``perturb``, or
  ``radiance_field_noise_std > 0``): the frame's generator is registered
  with every graph, so that each replay advances it as the eager chunk
  does; a frame drawn from another generator drops the graphs.

``pdf_padding`` is a Python branch of the resampler, and part of the key.

A graph is captured at the first chunk of its shape, which is rendered
eagerly first, on a side stream as capturing asks (lazy set-up such as the
kernel library's load happens there): its maps are that chunk's, and it
draws from the frame's generator, so that a frame's kernels, launch counts
and draws are the eager frame's whichever of its chunks capture.  Then the
capture, counted in ``graph.captures`` and said on a ``[graph]`` line of
standard error; the two are the span ``ddnerf.render.capture``, each
replay (the first of a frame after the weight pack's) the span
``ddnerf.render.replay``.  There is no fallback: a capture that fails
raises.  Every capture sets the counter ``render.graph_nodes`` to the
device operations (kernel, memcpy and memset nodes) a frame of its plan
replays.  All the graphs of a renderer share one memory pool: they never
run at once, and each chunk's maps are cloned before the next replay.
"""

from __future__ import annotations

import sys
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from ddnerf_tpu_torch.kernels import fused_mlp
from ddnerf_tpu_torch.models.nerf import NerfPipeline, ScheduleValues
from ddnerf_tpu_torch.utils import profiling
from ddnerf_tpu_torch.utils.profiling import span

CHUNK_ROOT = "ddnerf.render.chunk"
Maps = Dict[int, Dict[str, torch.Tensor]]
Parts = Dict[int, Dict[str, list]]


def chunk_plan(n: int, chunk: int) -> List[Tuple[int, int]]:
    """The ``[start, stop)`` ranges that cover ``n`` rays in order, in
    chunks of ``chunk`` rays and a shorter last one where ``chunk`` does
    not divide ``n``."""
    return [(start, min(start + chunk, n)) for start in range(0, n, chunk)]


class GraphKey(NamedTuple):
    """What a chunk's graph is captured for: its rays, the render mode,
    the maps it returns, the resampler's ``pdf_padding`` branch and the
    networks' compute dtype."""

    rows: int
    mode: str
    keys: Tuple[str, ...]
    pdf_padding: bool
    dtype: torch.dtype


def collect(parts: Parts, maps: Maps, rows: int, copy: bool = False) -> None:
    """Append a chunk of ``rows`` rays' maps to ``parts``: a 0-d value
    weighted by the rays, a map as it is or, with ``copy``, a clone."""
    for i in (0, 1):
        for key, v in maps[i].items():
            parts[i].setdefault(key, []).append(
                v * rows if v.dim() == 0 else v.clone() if copy else v)


class _Captured(NamedTuple):
    graph: torch.cuda.CUDAGraph
    census: profiling.GraphCensus
    inputs: Tuple[torch.Tensor, ...]  # origins, directions, radii
    maps: Maps
    launches: Dict[str, int]  # the fused kernels' launch nodes, by name


class ChunkGraphs:
    """The captured chunks of one renderer; ``draws``: whether the mode's
    settings draw from the generator.  It keeps no reference to the
    renderer, so its graphs go when the renderer does, never in a garbage
    collection that may run while another graph is being captured (a
    graph freed then invalidates that capture)."""

    def __init__(self, pipeline: NerfPipeline, mode: str, draws: bool):
        self.pipeline, self.mode, self.draws = pipeline, mode, draws
        self.dtype = pipeline.coarse.compute_dtype
        self.drop()

    def drop(self) -> None:
        """Forget every graph: the next frame captures them anew."""
        self._chunks: Dict[GraphKey, _Captured] = {}
        self._pack: Optional[Tuple[torch.cuda.CUDAGraph,
                                   profiling.GraphCensus, dict]] = None
        self._pool = None
        self._binding = None
        self._smooth: Optional[torch.Tensor] = None

    def key(self, rows: int, keys: Tuple[str, ...],
            sched: ScheduleValues) -> GraphKey:
        return GraphKey(rows, self.mode, tuple(keys), bool(sched.pdf_padding),
                        self.dtype)

    def run(self, run_chunk: Callable[..., Maps], origins: torch.Tensor,
            directions: torch.Tensor, radii: torch.Tensor,
            generator: Optional[torch.Generator], sched: ScheduleValues,
            keys: Tuple[str, ...], plan: List[Tuple[int, int]]) -> Parts:
        """Render the rays of ``plan``'s chunks (CUDA tensors ``[N, 3]``,
        ``[N, 3]``, ``[N, 1]``) -> each key's per-chunk maps, in order, for
        the renderer to join.  ``run_chunk(origins, directions, radii,
        generator, sched, keys)`` is the renderer's eager chunk: a chunk
        whose graph is missing is rendered by it and then captured
        (:meth:`_capture`), so a frame's kernels and draws are the eager
        frame's whichever chunks capture."""
        generator = generator if self.draws else None
        binding = (tuple(p.data_ptr() for p in self.pipeline.parameters()),
                   generator)
        if binding != self._binding:
            self.drop()
            self._binding = binding
        if self._smooth is None:
            self._smooth = torch.zeros((), dtype=torch.float32,
                                       device=origins.device)
        smooth = sched.gaussian_smooth_factor
        if isinstance(smooth, torch.Tensor):
            self._smooth.copy_(smooth)
        else:
            self._smooth.fill_(float(smooth))
        fed = ScheduleValues(gaussian_smooth_factor=self._smooth,
                             pdf_padding=bool(sched.pdf_padding))
        rays = (origins, directions, radii)
        parts: Parts = {0: {}, 1: {}}
        fresh = packed = False
        for start, stop in plan:
            key = self.key(stop - start, keys, sched)
            c = self._chunks.get(key)
            if c is None:
                with span("ddnerf.render.capture"):
                    maps, self._chunks[key] = self._capture(
                        run_chunk, key, tuple(r[start:stop] for r in rays),
                        generator, sched, fed)
                collect(parts, maps, stop - start)
                fresh = True
                continue
            with span("ddnerf.render.replay"), torch.inference_mode():
                if not packed and self._pack is not None:
                    graph, census, _ = self._pack
                    profiling.replaying(census)
                    graph.replay()
                packed = True
                for static, r in zip(c.inputs, rays):
                    static.copy_(r[start:stop])
                profiling.replaying(c.census)
                c.graph.replay()
                for name, n in c.launches.items():
                    fused_mlp.LAUNCHES[name] += n
                collect(parts, c.maps, stop - start, copy=True)
        if fresh:
            self._count_nodes([self.key(stop - start, keys, sched)
                               for start, stop in plan])
        return parts

    # ----------------------------------------------------------- capture

    def _capture(self, run_chunk: Callable[..., Maps], key: GraphKey,
                 rays: Tuple[torch.Tensor, ...],
                 generator: Optional[torch.Generator], sched: ScheduleValues,
                 fed: ScheduleValues) -> Tuple[Maps, _Captured]:
        """The chunk of ``rays`` rendered eagerly on a side stream, as
        capturing asks (its maps are the chunk's, its draws the frame's),
        then its graph captured on static copies of the rays, reading
        ``fed`` -> (the maps, the graph)."""
        dev = rays[0].device
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            maps = run_chunk(*rays, generator, sched, key.keys)
        main.wait_stream(side)
        for i in (0, 1):
            for v in maps[i].values():
                v.record_stream(main)
        inputs = tuple(r.clone(memory_format=torch.contiguous_format)
                       for r in rays)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        if self._pack is None and self.pipeline.use_kernel:
            self._pack = self._capture_pack()
        packs = self._pack[2] if self._pack is not None else {}
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        if generator is not None:
            graph.register_generator_state(generator)
        before = dict(fused_mlp.CAPTURED)
        with profiling.GraphCensus() as census, fused_mlp.held_packs(packs):
            with torch.cuda.graph(graph, pool=self._pool):
                static = run_chunk(*inputs, generator, fed, key.keys)
            census.count(graph.raw_cuda_graph())
            graph.instantiate()
        self._say(census, f"{key.rows} rays, pdf_padding={key.pdf_padding}",
                  census.by_stage(CHUNK_ROOT))
        launches = {name: n - before.get(name, 0)
                    for name, n in fused_mlp.CAPTURED.items()
                    if n != before.get(name, 0)}
        return maps, _Captured(graph, census, inputs, static, launches)

    def _capture_pack(self):
        """The graph that packs every network's weights -> (graph, census,
        the packs by network)."""
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with profiling.GraphCensus() as census:
            with torch.cuda.graph(graph, pool=self._pool):
                packs = {net: fused_mlp.pack_weights(net)
                         for net in self.pipeline.networks()}
            census.count(graph.raw_cuda_graph())
            graph.instantiate()
        self._say(census, "weight pack", None)
        return graph, census, packs

    @staticmethod
    def _say(census: profiling.GraphCensus, what: str,
             stages: Optional[str]) -> None:
        profiling.count("graph.captures")
        said = (f"{census.ops} device operations, {census.events} event nodes"
                if census.ops is not None else f"not counted ({census.refused})")
        if stages is not None and census.ops is not None:
            said += f"; nodes by stage: {stages}"
        print(f"[graph] capture {profiling.counter('graph.captures')}, render "
              f"{what}: {said}", file=sys.stderr, flush=True)

    def _count_nodes(self, keys: List[GraphKey]) -> None:
        """``render.graph_nodes``: the device operations of the frame's
        replays, the weight pack's and each chunk's graph's."""
        ops = [self._chunks[key].census.ops for key in keys]
        if self._pack is not None:
            ops.append(self._pack[1].ops)
        if None not in ops:
            profiling.set_counter("render.graph_nodes", sum(ops))
