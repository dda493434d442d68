"""Port weights: the JAX-tree transplant copies (never aliases) its
source, and a reference-format checkpoint written by the port loads in the
JAX package (train/torch_compat.py) and gives the same network outputs."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ddnerf_tpu.models.mlp import DepthMipMLP as JaxDepthMLP
from ddnerf_tpu.models.mlp import MipMLP as JaxMLP
from ddnerf_tpu.train.torch_compat import load_torch_checkpoint
from ddnerf_tpu_torch.models.mlp import DepthMipMLP, MipMLP
from ddnerf_tpu_torch.utils.weights import (
    load_checkpoint,
    params_to_state_dict,
    save_checkpoint,
)


def _jax_params(depth_head, hidden=16, seed=0):
    mod = (JaxDepthMLP if depth_head else JaxMLP)(hidden_size=hidden)
    return mod, mod.init(jax.random.PRNGKey(seed), jnp.zeros((1, 1, 96)),
                         jnp.zeros((1, 1, 27)))["params"]


def test_transplant_copies_and_does_not_alias():
    _, params = _jax_params(True)
    src = jax.tree_util.tree_map(lambda a: np.array(a), params)
    sd = params_to_state_dict(src)
    before = {k: v.clone() for k, v in sd.items()}
    for leaves in src.values():  # mutate every source array in place
        for a in leaves.values():
            a += 1.0
    for k, v in sd.items():
        assert torch.equal(v, before[k]), k
    # Names and layout: kernel [in, out] -> weight [out, in].
    assert sd["layers_xyz.5.weight"].shape == (16, 96 + 16)
    assert sd["layers_dir.0.weight"].shape == (128, 16 + 27)
    np.testing.assert_array_equal(sd["fc_mu_sigma.weight"].numpy(),
                                  np.asarray(params["fc_mu_sigma"]["kernel"]).T)
    net = DepthMipMLP(hidden_size=16)
    net.load_state_dict(sd)
    with torch.no_grad():  # the module's storage is its own as well
        net.fc_feat.weight.zero_()
    assert not torch.equal(sd["fc_feat.weight"], net.fc_feat.weight)


def test_unknown_parameter_group_is_rejected():
    with pytest.raises(KeyError):
        params_to_state_dict({"mystery": {"kernel": np.zeros((2, 2)),
                                          "bias": np.zeros(2)}})


def test_port_checkpoint_loads_in_jax_with_same_outputs(tmp_path):
    gen = torch.Generator().manual_seed(3)
    coarse = DepthMipMLP(hidden_size=16, generator=gen)
    fine = MipMLP(hidden_size=16, generator=gen)
    path = os.path.join(tmp_path, "checkpoint.ckpt")
    save_checkpoint(path, coarse, fine, step=1234)

    loaded = load_torch_checkpoint(path)
    assert loaded["step"] == 1234
    assert set(loaded["params"]) == {"coarse", "fine"}

    rng = np.random.default_rng(0)
    ipe = rng.standard_normal((4, 5, 96)).astype(np.float32)
    dirs = rng.standard_normal((4, 27)).astype(np.float32)
    for key, net, jmod in (("coarse", coarse, JaxDepthMLP(hidden_size=16)),
                           ("fine", fine, JaxMLP(hidden_size=16))):
        want = jmod.apply({"params": loaded["params"][key]}, jnp.asarray(ipe),
                          jnp.asarray(dirs)[:, None, :])
        with torch.no_grad():
            got = net(torch.tensor(ipe), torch.tensor(dirs))
        # f32 on both sides, same formulation up to summation order.
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)

    back = load_checkpoint(path)
    assert back["step"] == 1234
    for k, v in coarse.state_dict().items():
        assert torch.equal(back["coarse"][k], v)
    for k, v in fine.state_dict().items():
        assert torch.equal(back["fine"][k], v)
