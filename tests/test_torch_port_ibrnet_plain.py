"""The port's plain ``IBRNet`` aggregator (``neuray_tpu_torch/models/
ibrnet.py``) against the JAX package's (``neuray_tpu/models/ibrnet.py:
IBRNet``), with JAX's initialized parameters carried across by
``utils/params.py: load_flax_params``, at 1e-4 with JAX at "highest"
matmul precision (ROADMAP hazard a). Inputs: 3 and 8 views, 16 and 64
samples, masks with views missing, points seen by one view (the ray
attention's mask quirk, hazard b: a masked point blanks its query row)
and by none (sigma 0)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuray_tpu.models import ibrnet as jI

from neuray_tpu_torch.models import ibrnet as I
from neuray_tpu_torch.utils.params import load_flax_params, torch_to_flax

torch.set_num_threads(1)


def inputs(seed, b, dn, rfn, f=32):
    rng = np.random.RandomState(seed)
    rgb_feat = rng.randn(b, dn, rfn, 3 + f).astype(np.float32)
    rgb_feat[..., :3] = rng.rand(b, dn, rfn, 3)
    ray_diff = rng.randn(b, dn, rfn, 4).astype(np.float32) * 0.3
    mask = (rng.rand(b, dn, rfn, 1) > 0.3).astype(np.float32)
    mask[0, :4] = 0.0                    # seen by no view: sigma 0
    mask[0, 4:8] = 0.0
    mask[0, 4:8, 0] = 1.0                # seen by one view: masked row
    return rgb_feat, ray_diff, mask


@pytest.mark.parametrize("seed,b,dn,rfn", [(0, 5, 16, 3), (1, 3, 64, 8)])
def test_ibrnet_plain(seed, b, dn, rfn):
    rgb_feat, ray_diff, mask = inputs(seed, b, dn, rfn)
    net = jI.IBRNet(n_samples=64)
    with jax.default_matmul_precision("highest"):
        params = jax.jit(net.init)(jax.random.PRNGKey(seed), rgb_feat,
                                   ray_diff, mask)
        want = np.asarray(jax.jit(net.apply)(params, rgb_feat, ray_diff,
                                             mask))
    ours = I.IBRNet(n_samples=64)
    load_flax_params(ours, params)
    with torch.no_grad():
        got = ours(*(torch.from_numpy(x) for x in (rgb_feat, ray_diff,
                                                   mask))).numpy()
    assert got.shape == want.shape == (b, dn, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert (got[0, :4, 3] == 0).all()
    assert np.isfinite(got).all() and np.abs(want).max() > 0.1


def test_ibrnet_plain_parameter_tree():
    """The port's parameters carry back to JAX's tree leaf for leaf."""
    rgb_feat, ray_diff, mask = inputs(2, 2, 16, 3)
    params = jax.eval_shape(jI.IBRNet().init, jax.random.PRNGKey(0),
                            rgb_feat, ray_diff, mask)
    back = torch_to_flax(I.IBRNet())
    flat = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert flat.keys() == flat_back.keys()
    for k, v in flat.items():
        assert flat_back[k].shape == v.shape, k
