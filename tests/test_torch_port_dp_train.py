"""The port's multi-rank training on the CPU (gloo, spawned ranks with a
``file://`` rendezvous, ``tests/torch_port_ranks.py``): the
data-parallel generalization step, the ray-sharded finetuning step, and
the training and render CLIs on 2 ranks.

Gen step: 2 ranks on the synthetic samples 0 and 1 of
``tests/test_torch_port_train.py`` (3 views at 64x64, 32 query rays on
the sphere, 8 coarse samples, the depth loss, no fine resampling, so the
step draws nothing), from the trained ``tools/bench_weights.npz``, each
rank handed JAX's cross-view diff features of its sample (that test's
reason). The all-reduced gradients equal the mean of the one-process
gradients on the two samples (1e-6), and the JAX package's
``make_dp_train_step`` on 2 devices gives the same loss values (1e-4)
and gradients (2e-3 per leaf in relative norm, read through an identity
transformation chained before Adam).

FT step: ``tests/test_torch_port_ft.py``'s scene and weights, 31 rays
(padded to 32 on 2 ranks, 33 on 3, weighted 0), no fine resampling;
``FtTrainer.train_step`` on 2 and 3 ranks against one process on the
same batch (1e-6 on every gradient, ``ray_feats`` included), and against
the JAX package's ``make_sharded_train_step`` on 2 devices as
``tests/test_ft.py`` holds JAX's against its one device (values 1e-5,
gradients 2e-3). The JAX steps run in a subprocess (ROADMAP Queue 3,
hazard f) at "highest" matmul precision.

The CLIs: ``run_training`` (gen, data-parallel, with a sharded
validation; FT, ray-sharded) and ``render`` (gen exact, gen auto_focus,
ft) on 2 ranks at tiny sizes: parameters bit-identical across ranks, one
checkpoint (rank 0's), the FT steps' logged losses those of the
one-process CLI (``chip_smoke.check_cli_losses``), the frames byte-equal
to the one-process CLI's, and
``n_devices`` other than the world size refused.
"""
import os
import pickle
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

import chip_smoke

from neuray_tpu.models import init_net as jN
from neuray_tpu_torch.data import database as DB
from neuray_tpu_torch.models import ft as F
from neuray_tpu_torch.models import renderer as R
from neuray_tpu_torch.selfcheck import (
    DATABASE, GEN_CFG, RENDERS, ft_config, in_work_dir, write_cfg,
    write_gen_checkpoint, write_scene)
from neuray_tpu_torch.utils.params import (
    ft_torch_to_flax, load_ft_flax_params, load_params_npz, torch_to_flax)
from tests import torch_port_ranks as ranks
from tests.test_torch_port_ft import (
    CFG as FT_PARITY_CFG, GEN_CFG as FT_GEN_CFG, N_TRAIN, SIZE)
from tests.test_torch_port_parallel import spawn
from tests.test_torch_port_train import CFG as TRAIN_CFG, ROOT, sphere_sample
from tests.test_torch_port_trainer import make_cfg

torch.set_num_threads(1)

WEIGHTS = str(ROOT / "tools" / "bench_weights.npz")
FINE = ("fine_agg_net", "fine_dist_decoder")
GEN_STEP_CFG = dict(TRAIN_CFG, use_hierarchical_sampling=False,
                    use_nr_fine_loss=False)
FT_STEP_CFG = dict(FT_PARITY_CFG, use_hierarchical_sampling=False,
                   use_nr_fine_loss=False, train_ray_num=31,
                   use_validation=False)

# the JAX side, in a subprocess: inputs and outputs by pickle (this
# test's own files)
JAX_STEP = r"""
import pickle, sys
import numpy as np
import jax, jax.numpy as jnp, optax
jax.config.update("jax_platforms", "cpu")
from neuray_tpu.parallel import sharding as jP

work = sys.argv[1]
with open(f"{work}/jax_in.pkl", "rb") as f:
    inp = pickle.load(f)
cfg = inp["cfg"]
capture = optax.GradientTransformation(
    lambda p: jax.tree.map(jnp.zeros_like, p), lambda u, s, p=None: (u, u))
opt = optax.chain(capture, optax.adam(1e-4))
params = jax.tree.map(jnp.asarray, inp["params"])
with jax.default_matmul_precision("highest"):
    mesh = jP.make_mesh(2)
    if inp["kind"] == "gen":
        from neuray_tpu.models import renderer as jR
        from neuray_tpu.train import losses as jL
        step = jP.make_dp_train_step(
            jR.NeurayRenderer(jR.RenderConfig.from_cfg(cfg)), opt,
            jL.build_losses(cfg), mesh)
        batch = jax.tree.map(lambda *xs: np.stack(xs), *inp["samples"])
        _, state, metrics = step(params, opt.init(params), batch,
                                 jax.random.PRNGKey(0))
    else:
        from neuray_tpu.data import database as jDB
        from neuray_tpu.models import ft as jF
        jDB.DATA_ROOT = inp["root"]
        jft = jF.FtRenderer(dict(cfg))
        que = jft._build_que_train(inp["ref_idx"], inp["que_i"],
                                   np.random.RandomState(4))
        step = jft.make_sharded_train_step(opt, mesh)
        _, state, metrics = step(params, opt.init(params),
                                 np.asarray(inp["ref_idx"]), que,
                                 np.asarray(inp["que_i"]),
                                 jax.random.PRNGKey(0))
        metrics = jP.unreplicate(metrics)
    grads = jP.unreplicate(state)[0]
flat = {jax.tree_util.keystr(k): np.asarray(v)
        for k, v in jax.tree_util.tree_flatten_with_path(grads)[0]}
with open(f"{work}/jax_out.pkl", "wb") as f:
    pickle.dump({"grads": flat,
                 "metrics": {k: float(v) for k, v in metrics.items()}}, f)
"""


def start_jax(work: Path, inputs) -> subprocess.Popen:
    work.mkdir(parents=True, exist_ok=True)
    with open(work / "jax_in.pkl", "wb") as f:
        pickle.dump(inputs, f)
    return subprocess.Popen([sys.executable, "-c", JAX_STEP, str(work)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            env=dict(os.environ, JAX_PLATFORMS="cpu"))


def jax_result(proc: subprocess.Popen, work: Path, timeout=600):
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    assert proc.returncode == 0, out.decode()[-4000:]
    with open(work / "jax_out.pkl", "rb") as f:
        return pickle.load(f)


def flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def compare_flat(got, want, tol=2e-3, floor=1e-6):
    """``tests/test_torch_port_train.py: compare_grad_trees`` on flattened
    trees: per leaf |got - want| <= tol |want| + floor."""
    assert set(got) == set(want)
    bad = []
    for k in sorted(want):
        a, b = (np.asarray(x, np.float64) for x in (got[k], want[k]))
        assert a.shape == b.shape, k
        err, nb = np.linalg.norm(a - b), np.linalg.norm(b)
        if err > tol * nb + floor:
            bad.append(f"{k}: |d|={err:.3e} |ref|={nb:.3e}")
    assert not bad, "gradient mismatches:\n" + "\n".join(bad)
    return len(want)


def assert_same_tensors(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def assert_grads_close(got, want, tol=1e-6, floor=1e-7):
    """Per leaf |got - want| <= tol |want| + floor (norms): the sharded
    sums run in another order than one process's. ``floor``: the rounding
    left in the exactly-zero gradients of conv biases that feed an
    InstanceNorm (``compare_grad_trees``' reason)."""
    assert got.keys() == want.keys()
    bad = {k: ((got[k] - w).norm().item(), w.norm().item())
           for k, w in want.items()}
    bad = {k: e for k, e in bad.items() if not e[0] <= tol * e[1] + floor}
    assert not bad, f"gradients outside {tol} of their norm: {bad}"


# ---------------- the data-parallel gen step ----------------

@pytest.fixture(scope="module")
def gen_run(tmp_path_factory):
    """The JAX package's 2-device step (a subprocess, started first), the
    port's 2 ranks and its one process on each sample."""
    weights = load_params_npz(WEIGHTS)
    tree = {"params": {k: v for k, v in weights["params"].items()
                       if k not in FINE}}
    samples = [sphere_sample(i) for i in range(2)]
    for s in samples:
        s.pop("scene_name", None)
    work = tmp_path_factory.mktemp("gen_step")
    proc = start_jax(work / "jax", {"kind": "gen", "cfg": GEN_STEP_CFG,
                                    "params": tree, "samples": samples})
    with jax.default_matmul_precision("highest"):
        diff = []
        for s in samples:
            ref = s["ref"]
            depth_n = jN.extract_depth_for_init(ref["depth_range"],
                                                ref["depth"])
            diff.append(np.asarray(jax.jit(jN.get_diff_feats)(
                ref["imgs"], depth_n, ref["depth_range"], ref["poses"],
                ref["Ks"])))
    inp = {"samples": samples, "cfg": GEN_STEP_CFG, "tree": tree,
           "diff": diff}
    outs = spawn(ranks.gen_step_rank, 2, work / "port", inp)
    one = [ranks.gen_step(s, GEN_STEP_CFG, tree, d)
           for s, d in zip(samples, diff)]
    return outs, one, jax_result(proc, work / "jax"), tree


def test_dp_gen_ranks_hold_the_same_parameters(gen_run):
    outs = gen_run[0]
    assert_same_tensors(outs[0]["params"], outs[1]["params"])
    assert_same_tensors(outs[0]["grads"], outs[1]["grads"])
    assert outs[0]["values"] == outs[1]["values"]


def test_dp_gen_step_is_the_mean_of_the_one_process_steps(gen_run):
    outs, one = gen_run[:2]
    mean = {k: (one[0]["grads"][k] + one[1]["grads"][k]) / 2
            for k in one[0]["grads"]}
    assert_grads_close(outs[0]["grads"], mean)
    for k, v in outs[0]["values"].items():
        assert v == pytest.approx(
            (one[0]["values"][k] + one[1]["values"][k]) / 2, abs=1e-6), k
    # the two samples' gradients differ: the mean is not one of them
    assert any(not torch.allclose(one[0]["grads"][k], one[1]["grads"][k])
               for k in one[0]["grads"])


def test_dp_gen_step_matches_jax(gen_run):
    outs, _, theirs, tree = gen_run
    r = R.NeurayRenderer(R.RenderConfig.from_cfg(GEN_STEP_CFG))
    ours = flat(torch_to_flax(r, outs[0]["grads"]))
    assert compare_flat(ours, theirs["grads"]) == len(flat(tree))
    assert set(theirs["metrics"]) == set(outs[0]["values"])
    for k, v in theirs["metrics"].items():
        assert outs[0]["values"][k] == pytest.approx(v, abs=1e-4), k


# ---------------- the ray-sharded FT step ----------------

@pytest.fixture(scope="module")
def ft_inputs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ft_scene"))
    from neuray_tpu_torch.data.synthetic import write_nerf_synthetic_sphere
    write_nerf_synthetic_sphere(root, n_train=N_TRAIN, size=SIZE)
    weights = load_params_npz(WEIGHTS)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(DB, "DATA_ROOT", root)
        ft = F.FtRenderer(dict(FT_STEP_CFG), device="cpu")
        gen = R.NeurayRenderer(R.RenderConfig.from_cfg(FT_GEN_CFG))
        from neuray_tpu_torch.utils.params import load_flax_params
        load_flax_params(gen, weights)
        feats = ft.init_ray_feats_from_gen(gen).numpy()
        tree = {"net": {"params": {
            k: v for k, v in weights["params"].items()
            if k not in FINE + ("init_net",)}}, "ray_feats": feats}
        load_ft_flax_params(ft, tree)
        que_i, ref_idx = ft.sample_train_indices(np.random.RandomState(3))
    return {"root": root, "cfg": FT_STEP_CFG, "tree": tree,
            "state": {k: v.clone() for k, v in ft.state_dict().items()},
            "ref_idx": ref_idx, "que_i": int(que_i)}, ft


@pytest.fixture(scope="module")
def ft_run(ft_inputs, tmp_path_factory):
    inp, _ = ft_inputs
    work = tmp_path_factory.mktemp("ft_step")
    proc = start_jax(work / "jax", {
        "kind": "ft", "cfg": FT_STEP_CFG, "params": inp["tree"],
        "root": inp["root"], "ref_idx": inp["ref_idx"],
        "que_i": inp["que_i"]})
    port = {n: spawn(ranks.ft_step_rank, n, work / f"port{n}",
                     {k: v for k, v in inp.items() if k != "tree"})
            for n in (2, 3)}
    one = ranks.ft_step(inp)
    return port, one, jax_result(proc, work / "jax")


@pytest.mark.parametrize("size,tol", [(2, 1e-6), (3, 1e-5)])
def test_sharded_ft_step_equals_one_process(ft_run, size, tol):
    """31 rays over 2 and 3 ranks (1 and 2 pad rays of weight 0): every
    gradient (ray_feats included) within tol of its norm and every loss
    value of the one-process step on the same batch, and the same
    parameters on every rank. On 3 ranks the image encoder's reductions
    over its 4 views run in three parts and the backward's factor 3 and
    the averaging's 1/3 round: measured 4.8e-6 of conv1's norm at worst
    (2 ranks: within 1e-6)."""
    outs, one = ft_run[0][size], ft_run[1]
    for other in outs[1:]:
        assert_same_tensors(outs[0]["params"], other["params"])
    assert_grads_close(outs[0]["grads"], one["grads"], tol)
    assert set(outs[0]["values"]) == set(one["values"])
    for k, v in one["values"].items():
        assert outs[0]["values"][k] == pytest.approx(v, abs=1e-6), k
    assert one["grads"]["ray_feats"].abs().max() > 0


def test_sharded_ft_step_matches_jax(ft_inputs, ft_run):
    _, ft = ft_inputs
    ours, theirs = ft_run[0][2][0], ft_run[2]
    got = flat(ft_torch_to_flax(ft, ours["grads"]))
    assert compare_flat(got, theirs["grads"]) == len(theirs["grads"])
    assert set(theirs["metrics"]) == set(ours["values"])
    for k, v in theirs["metrics"].items():
        assert ours["values"][k] == pytest.approx(v, abs=1e-5), k


# ---------------- the CLIs on 2 ranks ----------------

def cli_cfgs(work: Path, output_root: str):
    """The configs of the CLI runs, written under work."""
    gen_train = make_cfg(output_root, total_step=3, name="dp_gen",
                         val_interval=3, val_set_list=[{
                             "name": "sphere", "type": "synthetic",
                             "cfg": {"rfn": 3, "h": 32, "w": 32, "num": 2}}])
    ft = dict(ft_config(2), use_validation=True, val_interval=2,
              train_log_step=1, train_ray_num=63)
    auto = dict(GEN_CFG, name="dp_auto", load_ckpt_name=GEN_CFG["name"],
                skip_empty_rays=True, skip_empty_threshold=0.05,
                skip_mode="auto_focus", probe_sample_num=8,
                ray_batch_num=256)
    return {k: write_cfg(work / f"{k}.yaml", v) for k, v in (
        ("gen_train", gen_train), ("ft", ft), ("gen", GEN_CFG),
        ("auto", auto), ("bad", dict(gen_train, n_devices=3)),
        ("ft_one", dict(ft, name="ft_one")),
        ("ft_zero", dict(ft, name="ft_zero",
                         lr_cfg=dict(ft["lr_cfg"], lr_init=0.0))))}


def render_argv(cfg, *extra):
    return ["--database_name", DATABASE, "--cfg", cfg, "--pose_type",
            "eval", "--ray_num", "256", "--device", "cpu", *extra]


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """Both CLIs on 2 ranks in one work dir, then in another the FT
    training CLI in one process on the same config and at lr 0, and the
    render CLI in one process on the same checkpoints."""
    two, one = (tmp_path_factory.mktemp(n) for n in ("two", "one"))
    weights = load_params_npz(WEIGHTS)
    for work in (two, one):
        with in_work_dir(work):
            write_scene(work, 32)
            write_gen_checkpoint("data/model", GEN_CFG, weights)
    cfgs = cli_cfgs(two, str(two / "data" / "model"))
    ft_argv = ["--database_name", DATABASE, "--cfg", cfgs["ft"],
               "--render_type", "ft", "--pose_type", "inter_8", "--re",
               "1", "--device", "cpu"]
    calls = [("neuray_tpu_torch.run_training",
              ["--cfg", cfgs["gen_train"], "--device", "cpu"]),
             ("neuray_tpu_torch.run_training",
              ["--cfg", cfgs["ft"], "--device", "cpu"]),
             ("neuray_tpu_torch.render", render_argv(cfgs["gen"])),
             ("neuray_tpu_torch.render", render_argv(cfgs["auto"])),
             ("neuray_tpu_torch.render", ft_argv)]
    outs = spawn(ranks.cli_rank, 2, two / "ranks",
                 {"dir": str(two), "calls": calls}, timeout=400)
    shutil.copytree(two / "data" / "model" / "selfcheck_ft",
                    one / "data" / "model" / "selfcheck_ft")
    from neuray_tpu_torch import render, run_training
    with in_work_dir(one):
        for cfg in ("ft_one", "ft_zero"):
            run_training.main(["--cfg", cfgs[cfg], "--device", "cpu"])
        for _, argv in calls[2:]:
            render.main(argv)
    return two, one, outs, cfgs


@pytest.mark.parametrize("call", [0, 1])
def test_training_cli_ranks_hold_the_same_parameters(cli_run, call):
    _, _, outs, _ = cli_run
    assert_same_tensors(outs[0][call], outs[1][call])


@pytest.mark.parametrize("name", ["dp_gen", "selfcheck_ft"])
def test_training_cli_writes_one_checkpoint(cli_run, name):
    """Rank 0's files only: the checkpoint holds the state every rank
    trained, the logs one line a log step, the validation one record."""
    two, _, outs, _ = cli_run
    model_dir = two / "data" / "model" / name
    ckpt = torch.load(model_dir / "ckpt.pt", weights_only=True)
    assert ckpt["step"] == (3 if name == "dp_gen" else 2)
    assert_same_tensors(ckpt["params"], outs[0][0 if name == "dp_gen" else 1])
    train_log = (model_dir / "train.txt").read_text().splitlines()
    assert len(train_log) == (1 if name == "dp_gen" else 2)
    val = "val-sphere.txt" if name == "dp_gen" else "val.txt"
    assert len((model_dir / val).read_text().splitlines()) == 1


def test_training_cli_losses_equal_one_process(cli_run):
    """The ray-sharded FT training CLI (63 rays over 2 ranks, one pad ray)
    logs the one-process CLI's losses, as ``chip_smoke.py`` phase 18
    holds them (``check_cli_losses``): step 1 to the log's 5 decimals,
    step 2 within a tenth of the update's effect (the one-process CLI
    against itself at lr 0), an effect that shows in the log."""
    two, one, _, _ = cli_run
    logs = {"two": two / "data" / "model" / "selfcheck_ft",
            "one": one / "data" / "model" / "ft_one",
            "zero": one / "data" / "model" / "ft_zero"}
    logs = {k: chip_smoke.train_log(d / "train.txt") for k, d in logs.items()}
    out = chip_smoke.check_cli_losses(logs, 2, "training CLI")
    assert list(out) == [2]


@pytest.mark.parametrize("case", ["no update", "diverged", "steps"])
def test_cli_loss_check_fails(case):
    """``check_cli_losses`` refuses a sharded CLI that did not update, one
    that moved off the one-process update, and a missing step."""
    one = {1: {"loss_a": 0.5, "loss_total": 0.5},
           2: {"loss_a": 0.4, "loss_total": 0.4}}
    zero = {1: dict(one[1]), 2: {"loss_a": 0.45, "loss_total": 0.45}}
    two = {"no update": zero, "steps": {1: one[1]},
           "diverged": {1: one[1], 2: {"loss_a": 0.41,
                                       "loss_total": 0.41}}}[case]
    with pytest.raises(RuntimeError):
        chip_smoke.check_cli_losses({"two": two, "one": one, "zero": zero},
                                    2, "training CLI")


@pytest.mark.parametrize("cfg,kind", [("gen", "eval"), ("auto", "eval"),
                                      ("ft", "inter_8")])
def test_render_cli_frames_equal_one_process(cli_run, cfg, kind):
    two, one, _, cfgs = cli_run
    name = {"gen": GEN_CFG["name"], "auto": "dp_auto",
            "ft": "selfcheck_ft"}[cfg]
    rel = f"{RENDERS}/{name}-{kind}"
    files = sorted(os.listdir(one / rel))
    assert files and files == sorted(os.listdir(two / rel))
    for fn in files:
        ours, theirs = ((d / rel / fn).read_bytes() for d in (two, one))
        assert ours == theirs, fn
    if cfg == "auto":
        assert len((two / rel / "auto_audit.jsonl").read_text()
                   .splitlines()) == 3


def test_n_devices_must_be_the_world_size(cli_run, tmp_path):
    two, _, _, cfgs = cli_run
    with pytest.raises(RuntimeError, match="torchrun --nproc_per_node 3"):
        spawn(ranks.cli_rank, 2, tmp_path, {
            "dir": str(two), "calls": [("neuray_tpu_torch.run_training",
                                        ["--cfg", cfgs["bad"], "--device",
                                         "cpu"])]})
