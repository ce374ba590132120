"""The rank side of the port's multi-rank tests
(``test_torch_port_parallel.py``, ``test_torch_port_dp_train.py``): each
function runs in a spawned rank (``parallel/spawn.py: run_ranks``) on the
CPU over gloo, reads its inputs from ``<work>/inputs.pt`` and writes what
it computed to ``<work>/rank<r>.pt``. This module imports torch and the
port only (a rank never loads JAX)."""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from neuray_tpu_torch.data import database as DB
from neuray_tpu_torch.models import init_net as N
from neuray_tpu_torch.models import renderer as R
from neuray_tpu_torch.parallel import sharding as P
from neuray_tpu_torch.train.losses import build_losses
from neuray_tpu_torch.train.trainer import adam_update
from neuray_tpu_torch.utils.params import load_flax_params, load_params_npz


def _load(work):
    # this test's own file, written by the test process
    return torch.load(Path(work) / "inputs.pt", weights_only=False)


def _save(work, mesh, out):
    torch.save(out, Path(work) / f"rank{mesh.rank}.pt")


def _renderer(cfg, weights):
    r = R.NeurayRenderer(R.RenderConfig(**cfg))
    load_flax_params(r, load_params_npz(weights))
    return r.eval()


def tensors(tree):
    """numpy leaves of a nested dict as tensors."""
    if isinstance(tree, dict):
        return {k: tensors(v) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree)) if isinstance(
        tree, np.ndarray) else tree


# ---------------- rendering ----------------

def render_and_drivers(mesh, work):
    """``make_sharded_render_fn`` on the raw scene, the probes and the
    four frame drivers with ``mesh`` on the maps the JAX package
    encoded (``inputs.pt``: see ``test_torch_port_parallel.py``)."""
    torch.set_num_threads(1)
    inp = _load(work)
    out = {}
    r = _renderer(inp["render_cfg"], inp["weights"])
    out["full"] = P.make_sharded_render_fn(r, mesh, inp["keep"])(
        tensors(inp["ref"]), tensors(inp["que"]))
    maps = R.NeurayRenderer.build_gather_cache(
        tensors({**inp["ref"], **inp["jax_maps"]}))
    out["on_jax_maps"] = P.make_sharded_render_fn(
        r, mesh, inp["keep"], pre_encoded=True)(maps, tensors(inp["que"]))

    d = _renderer(inp["driver_cfg"], inp["weights"])
    ref_c = R.NeurayRenderer.build_gather_cache(tensors(inp["driver_ref"]))
    que = tensors(inp["driver_que"])
    out["probe"] = R.probe_rays(d, ref_c, que, mesh)
    out["focus_probe"] = R.focus_probe_rays(d, ref_c, que, mesh)
    kw = dict(inp["driver_kw"], mesh=mesh)
    out["probe_focus"] = R.render_frame_probe_focus(
        d, ref_c, que, probe_out=tuple(tensors(inp["jax_focus_probe"])),
        **kw)
    out["probe_skip"] = R.render_frame_probe_skip(
        d, ref_c, que, probe_out=tensors(inp["jax_probe"]), **kw)
    out["skip_empty"] = R.render_frame_skip_empty(
        d, ref_c, que, threshold=kw["threshold"],
        keep_base=kw["keep_base"], mesh=mesh)
    out["auto"] = R.render_frame_probe_auto(d, ref_c, que, mesh=mesh,
                                            **inp["auto_kw"])
    _save(work, mesh, out)


# ---------------- losses ----------------

def _loss_outputs(inp, w1, w2, lo=0, n=None):
    """The outputs of a small model (w1, w2) on rays lo:lo+n of the
    batch, padded with copies of the last ray where it runs out."""
    x, gt, mask = inp["x"], inp["gt"], inp["mask"]
    rn = x.shape[1]
    if n is not None:
        def part(t):
            return P._pad_rays(t, lo + n)[:, lo:lo + n]
        x, gt, mask = part(x), part(gt), part(mask)
    return {"pixel_colors_nr": torch.sigmoid(x @ w1),
            "pixel_colors_gt": gt, "ray_mask": mask,
            "hit_prob_nr": torch.sigmoid(x @ w2),
            "hit_prob_self": torch.sigmoid(x @ w2 * 0.5 + 0.1)}, rn


def loss_values_and_grads(inp, mesh=None):
    """Every config's loss values and the gradients of w1, w2 (averaged
    over the ranks on a mesh): one process (mesh None) on the whole
    batch, else this rank's slice with ``ray_weight``."""
    results = []
    for cfg in inp["cfgs"]:
        w1 = inp["w1"].clone().requires_grad_()
        w2 = inp["w2"].clone().requires_grad_()
        if mesh is None:
            outputs, _ = _loss_outputs(inp, w1, w2)
        else:
            rn = inp["x"].shape[1]
            per = -(-rn // mesh.size)
            outputs, _ = _loss_outputs(inp, w1, w2, mesh.rank * per, per)
            weight = (torch.arange(per * mesh.size) < rn).float()[None]
            outputs["ray_weight"] = weight[:, mesh.rank * per:][:, :per]
        loss_fn = build_losses(cfg, mesh)
        opt = torch.optim.SGD([w1, w2], lr=0.0)
        values = adam_update(opt, [w1, w2], 0.0, loss_fn(outputs, {}), mesh,
                             loss_fn.names)
        results.append({"values": values, "w1": w1.grad, "w2": w2.grad})
    return results


def uneven_losses_rank(mesh, work):
    """Rank 0 holds loss_a, rank 1 loss_a and loss_b (as a sample with the
    depth-loss head beside one without), no rank loss_c: one update's
    averaged values and gradient."""
    w = torch.tensor([1.0, 2.0], requires_grad=True)
    losses = {"loss_a": (w * (mesh.rank + 1)).sum()[None]}
    if mesh.rank == 1:
        losses["loss_b"] = (w ** 2).sum()[None]
    values = adam_update(torch.optim.SGD([w], lr=0.0), [w], 0.0, losses,
                         mesh, ("loss_a", "loss_b", "loss_c"))
    _save(work, mesh, {"values": values, "grad": w.grad})


def losses_rank(mesh, work):
    torch.set_num_threads(1)
    _save(work, mesh, loss_values_and_grads(_load(work), mesh))


# ---------------- training steps ----------------

def gen_step(sample, cfg, tree, diff, mesh=None):
    """One data-parallel generalization step on ``sample`` (numpy, as the
    synthetic dataset makes it) from the flax weights ``tree``: the
    training forward with the init net's cross-view diff features
    ``diff`` handed in, the losses, the gradients (averaged on a mesh)
    and one Adam update. Returns the losses, the gradients and the
    parameters after the update."""
    renderer = R.NeurayRenderer(R.RenderConfig.from_cfg(cfg))
    load_flax_params(renderer, tree)
    renderer.train()
    batch = tensors(sample)
    orig = N.get_diff_feats
    N.get_diff_feats = lambda *args: torch.from_numpy(np.array(diff))
    try:
        out = renderer(batch["ref"], batch["que"], True,
                       batch.get("depth_loss_coords"))
    finally:
        N.get_diff_feats = orig
    loss_fn = build_losses(cfg)
    params = list(renderer.parameters())
    opt = torch.optim.Adam(params, lr=1e-4)
    values = adam_update(opt, params, 1e-4, loss_fn(out, batch), mesh,
                         loss_fn.names)
    return {"values": values,
            "grads": {n: p.grad.clone() for n, p in
                      renderer.named_parameters()},
            "params": {n: p.detach().clone() for n, p in
                       renderer.named_parameters()}}


def gen_step_rank(mesh, work):
    torch.set_num_threads(1)
    inp = _load(work)
    r = mesh.rank
    _save(work, mesh, gen_step(inp["samples"][r], inp["cfg"], inp["tree"],
                               inp["diff"][r], mesh))


def ft_step(inp, mesh=None, device="cpu"):
    """One finetuning step through ``FtTrainer.train_step`` from the state
    ``inp["state"]`` on the batch of ``inp`` (ray-sharded on a mesh).
    Returns the loss values, every gradient and the parameters after the
    update."""
    from neuray_tpu_torch.train.ft_trainer import FtTrainer
    root, DB.DATA_ROOT = DB.DATA_ROOT, inp["root"]
    try:
        trainer = FtTrainer(dict(inp["cfg"]), device, mesh)
    finally:
        DB.DATA_ROOT = root
    trainer.ft.set_ray_feats(inp["state"]["ray_feats"])
    trainer.ft.load_state_dict(inp["state"])
    trainer.build_optimizer()
    trainer.generator.manual_seed(7)
    ref_idx, que_i = inp["ref_idx"], inp["que_i"]
    que = trainer.ft._build_que_train(ref_idx, que_i,
                                      np.random.RandomState(4))
    values = trainer.train_step((ref_idx, que, que_i))
    return {"values": values,
            "grads": {n: p.grad.clone() for n, p in
                      trainer.ft.named_parameters()},
            "params": {n: p.detach().clone() for n, p in
                       trainer.ft.named_parameters()}}


def ft_step_rank(mesh, work):
    torch.set_num_threads(1)
    _save(work, mesh, ft_step(_load(work), mesh))


# ---------------- the CLIs ----------------

def cli_rank(mesh, work):
    """``inputs.pt``'s CLI calls (module name, argv) in its ``dir`` with
    the databases under ``dir/data``; each rank saves, by the call's
    index, the state of the model each training call returns."""
    import importlib

    from neuray_tpu_torch.selfcheck import in_work_dir
    torch.set_num_threads(1)
    inp = _load(work)
    out = {}
    with in_work_dir(inp["dir"]):
        for i, (name, argv) in enumerate(inp["calls"]):
            result = importlib.import_module(name).main(argv)
            if result is not None:
                out[i] = {k: v.detach().clone()
                          for k, v in result.state_dict().items()}
    _save(work, mesh, out)


def hang_rank(mesh, work):
    """Rank 0 waits in a collective that rank 1 never joins."""
    import time
    if mesh.rank == 0:
        torch.distributed.barrier()
    else:
        time.sleep(3600)
