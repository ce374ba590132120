"""Multi-GPU execution: ray-sharded rendering and data-parallel training
over ``torch.distributed`` (port of ``neuray_tpu/parallel/sharding.py``).

One process a rank, launched by ``torchrun`` or spawned
(``parallel/spawn.py: run_ranks``), stands in for the JAX package's mesh
axis and ``pmap``; ``make_mesh`` joins the process group and returns a
``Mesh`` (rank, size, the rank's device, backend).

  * RENDERING shards the ray axis of one scene: every rank encodes the
    scene (or takes the encoded one), pads the rays by copies of the last
    one to a multiple of ``size * ray_batch_num``, renders its contiguous
    slice through the renderer's own chunk loop, and the outputs are
    all-gathered and trimmed to [qn, rn, ...] (``shard_rays``). The chunk
    loop uses no collective. The JAX package builds one sharded function
    a pass (probe, focus probe, focused, coarse, fine render); here each
    of the renderer's ray loops takes the mesh (``render_rays``,
    ``probe_rays``, ... in ``models/renderer.py``), and
    ``make_sharded_render_fn`` adds the replicated encode.
  * TRAINING averages every parameter's gradient and the loss values over
    the ranks with one ``all_reduce`` of one flat buffer a step
    (``average_gradients``, the counterpart of the JAX package's
    ``pmean``); Adam then runs identically on every rank, so the
    parameters stay bit-identical. Generalization training gives each
    rank its own sample; finetuning shards one ray batch
    (``models/ft.py``), its loss reductions summed over the ranks by the
    differentiable ``all_reduce_sum`` (``train/losses.py``), whose
    backward is itself a sum: each rank's gradient carries a factor of
    ``size`` that the averaging cancels.

What differs from the JAX package: each rank holds one copy of the state,
so there is no ``unreplicate``; an explicit reduce stands in for
``DistributedDataParallel``, whose unused-parameter rule and hooks would
fight the trainers' zero gradient for a parameter without one (every rank
reduces the same set); the loss values travel in the same buffer as the
gradients, by the names the configured losses can report. A mesh of size
1 (or None) is one process: every sharded function is then the
unsharded one.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, Iterable, Sequence, Tuple

import torch
import torch.distributed as dist

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place among the ranks: its rank, the world size,
    its device and the process group's backend (None for one process)."""
    rank: int
    size: int
    device: torch.device
    backend: str | None = None

    @property
    def is_main(self) -> bool:
        """Rank 0: the one that writes files and logs."""
        return self.rank == 0

    def barrier(self) -> None:
        if self.size > 1:
            dist.barrier()

    def broadcast_object(self, obj):
        """Rank 0's ``obj`` on every rank (pickled; only this program's
        own objects)."""
        if self.size == 1:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=0)
        return box[0]


def _rule(dev: torch.device, local_size: int, count: int) -> str:
    return (f"rank r on cuda:(LOCAL_RANK % {count}); backend nccl when each "
            f"of the {local_size} local ranks has a card of its own, gloo "
            f"when ranks share one (nccl refuses two ranks on one card)"
            if dev.type == "cuda" else "ranks on the CPU over gloo")


def make_mesh(device=None, init_method: str | None = None,
              rank: int | None = None, size: int | None = None,
              verbose: bool = True) -> Mesh:
    """Join the ranks (``init_process_group``) and return this rank's
    ``Mesh``. Rank and world size come from ``rank`` / ``size``, else
    from the ``RANK`` / ``WORLD_SIZE`` that ``torchrun`` or the spawner
    sets (a process without them is a world of one); an initialized
    process group is joined as it is. ``init_method`` defaults to
    ``env://`` (``MASTER_ADDR`` / ``MASTER_PORT``).

    The device: ``device`` when given (``"cpu"`` for a run without a
    card, as the tests ask), else ``cuda:(LOCAL_RANK % device_count)``;
    without a CUDA device and without ``device`` this raises. The
    backend: nccl when each local rank has a card of its own, gloo when
    ranks share one or run on the CPU (the rule is printed once, by rank
    0)."""
    env = os.environ
    if dist.is_initialized():
        rank, size = dist.get_rank(), dist.get_world_size()
    else:
        rank = int(env.get("RANK", 0)) if rank is None else rank
        size = int(env.get("WORLD_SIZE", 1)) if size is None else size
    local_rank = int(env.get("LOCAL_RANK", rank))
    local_size = int(env.get("LOCAL_WORLD_SIZE", size))
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run on "
                               "the CPU")
        device = "cuda"
    dev = torch.device(device)
    if size == 1:
        return Mesh(rank, 1, dev)
    count = torch.cuda.device_count() if dev.type == "cuda" else 0
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", local_rank % count)
        torch.cuda.set_device(dev)
    backend = ("nccl" if dev.type == "cuda" and count >= local_size
               else "gloo")
    if dist.is_initialized():
        backend = dist.get_backend()
    else:
        dist.init_process_group(backend, init_method=init_method or "env://",
                                rank=rank, world_size=size)
    if verbose and rank == 0:
        print(f"mesh: {size} ranks, {_rule(dev, local_size, count)}: "
              f"backend {backend}", flush=True)
    return Mesh(rank, size, dev, backend)


# ---------------- collectives ----------------

def all_gather_rays(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's x [qn, n, ...] concatenated along the ray axis in rank
    order -> [qn, size * n, ...] on x's device. Gathered as bytes, so any
    dtype goes (bf16, bool); through the host under gloo (the frame goes
    there anyway), on the card under nccl."""
    part = x.contiguous()
    if mesh.backend != "nccl":
        part = part.cpu()
    raw = part.view(torch.uint8)          # the last axis in bytes
    parts = [torch.empty_like(raw) for _ in range(mesh.size)]
    dist.all_gather(parts, raw)
    return torch.cat(parts, 1).view(x.dtype).to(x.device)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks whose backward is the same sum, the transpose
    of the JAX package's ``psum`` under ``pmap``."""

    @staticmethod
    def forward(ctx, x):
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad)
        return grad


def all_reduce_sum(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """x summed over the mesh's ranks, differentiably (its gradient is
    summed too); x itself without a mesh or on one rank."""
    if mesh is None or mesh.size == 1:
        return x
    if not x.requires_grad:
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x)
        return x
    return _AllReduceSum.apply(x)


def average_gradients(params: Sequence[torch.Tensor], mesh: Mesh,
                      values: Dict[str, torch.Tensor],
                      names: Iterable[str]) -> Dict[str, float]:
    """Replace every parameter's gradient by its mean over the ranks, and
    return each of the step's loss values (``values``: name -> 0-dim
    tensor) averaged over the ranks that have it: one ``all_reduce`` of
    one flat buffer (gradients, then a value and a 0/1 count for each of
    ``names``, every name a rank may report: ``build_losses(...).names``).
    Ranks may hold different losses (a sample with the depth-loss head and
    one without: the JAX trainer's ``pmap`` only ever stacks samples of
    one structure); a name no rank holds is left out. Every parameter must
    have a gradient (the trainers give a zero one to those without)."""
    names = sorted(names)
    unknown = set(values) - set(names)
    if unknown:
        raise ValueError(f"loss values {sorted(unknown)} are not among the "
                         f"names {names}")
    grads = [p.grad for p in params]
    dev = grads[0].device
    zero = torch.zeros((), device=dev)
    flat = torch.cat([g.reshape(-1) for g in grads] + [
        torch.stack([values.get(n, zero).to(dev).float() for n in names]),
        torch.tensor([float(n in values) for n in names], device=dev)])
    dist.all_reduce(flat)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g) / mesh.size)
        offset += g.numel()
    sums, counts = flat[offset:].view(2, -1).tolist()
    means = {n: s / c for n, s, c in zip(names, sums, counts) if c}
    return {**{n: means[n] for n in values}, **means}    # values' order


@torch.no_grad()
def broadcast_module(module: torch.nn.Module, mesh: Mesh) -> None:
    """Rank 0's parameters and buffers on every rank."""
    if mesh.size == 1:
        return
    for t in module.state_dict().values():
        dist.broadcast(t, 0)


# ---------------- sharded rendering ----------------

def _pad_rays(x: torch.Tensor, n: int) -> torch.Tensor:
    """x [qn, rn, ...] padded to n rays with copies of the last one."""
    pad = n - x.shape[1]
    if pad <= 0:
        return x
    return torch.cat([x, x[:, -1:].expand(x.shape[0], pad, *x.shape[2:])], 1)


def rank_span(rn: int, mesh: Mesh, chunk: int = 1) -> Tuple[int, int]:
    """(first ray, ray count) of this rank's part of rn rays padded to a
    multiple of ``size * chunk``: the rank-th of size contiguous parts,
    each a whole number of chunks."""
    per = -(-rn // (mesh.size * chunk)) * chunk
    return mesh.rank * per, per


def rank_part(x: torch.Tensor, mesh: Mesh, chunk: int = 1) -> torch.Tensor:
    """This rank's part (``rank_span``) of x [qn, rn, ...], padded with
    copies of its last ray."""
    lo, per = rank_span(x.shape[1], mesh, chunk)
    return _pad_rays(x, per * mesh.size)[:, lo:lo + per]


def shard_rays(step: Callable[..., Tensors], que: Tensors,
               mesh: Mesh | None, chunk: int,
               rows: Iterable[torch.Tensor] = ()) -> Tensors:
    """Run ``step(que_slice, *row_slices) -> {key: [qn, n, ...]}`` on this
    rank's part of que's rays (``rank_part``: a whole number of ``chunk``s,
    so the chunk loop inside ``step`` pads nothing) and return every
    rank's outputs, gathered and trimmed to [qn, rn, ...]; ``rows`` are
    per-ray tensors [qn, rn, ...] split alongside the coords. Without a
    mesh, or on one rank, ``step(que, *rows)``."""
    if mesh is None or mesh.size == 1:
        return step(que, *rows)
    rn = que["coords"].shape[1]

    def part(x):
        return rank_part(x, mesh, chunk)

    out = step(dict(que, coords=part(que["coords"])), *map(part, rows))
    return {k: all_gather_rays(v, mesh)[:, :rn] for k, v in out.items()}


def make_sharded_render_fn(renderer, mesh: Mesh | None,
                           keep_keys=("pixel_colors_nr",
                                      "pixel_colors_nr_fine", "ray_mask"),
                           pre_encoded: bool = False):
    """The full render with the ray axis sharded over the mesh:
    fn(ref, que, src=None) -> the kept outputs [qn, rn, ...]. The scene
    encode is replicated (``encode_ref`` on every rank); with
    ``pre_encoded`` ``ref`` is already the encoded scene (``encode_ref``'s
    output), as for callers that render many frames of one scene. The
    probes and the partial passes of the frame drivers shard the same way
    through their ``mesh`` argument (``models/renderer.py``)."""
    from neuray_tpu_torch.models import renderer as R

    def fn(ref, que, src=None):
        ref_c = ref if pre_encoded else R.encode_ref(renderer, ref, src)
        return R.render_rays(renderer, ref_c, que, keep_keys, mesh)

    return fn
