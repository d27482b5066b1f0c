"""The port's DroidNet against ``vipe_tpu.models.droidnet`` with the same
weights: JAX params from ``init_droidnet`` go through
``droidnet_state_dict_from_flax`` into the torch model.

Tolerances: at f32 both sides run the same convolutions in another
summation order, atol 1e-4 (measured ≤1e-5).  At bf16 each side rounds
activations to bf16 after every convolution, at different places (XLA fuses
differently), and ~15 layers compound that: 5e-2 of the output's largest
magnitude (measured 2.5e-2 for the feature encoder, ≤1e-2 for the update).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vipe_tpu.models.convert import convert_droidnet
from vipe_tpu.models.droidnet import DroidNet as JaxDroidNet
from vipe_tpu.models.droidnet import init_droidnet
from vipe_tpu_torch.models import droidnet as tdn
from vipe_tpu_torch.models.convert import droidnet_state_dict_from_flax

HT, WD = 6, 8
E = 3
BF16_REL = 5e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU path runs thousands of tiny ops: intra-op threads
    only contend with the other test workers on the same cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)



@pytest.fixture(scope="module")
def weights():
    _, params = init_droidnet(jax.random.PRNGKey(0), HT, WD)
    params_np = jax.tree_util.tree_map(np.asarray, params)
    return params, droidnet_state_dict_from_flax(params_np), params_np


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    img = (rng.random((2, HT * 8, WD * 8, 3)) * 255).astype(np.uint8)
    net = (0.5 * rng.standard_normal((E, HT, WD, 128))).astype(np.float32)
    inp = np.abs(rng.standard_normal((E, HT, WD, 128))).astype(np.float32)
    corr = rng.standard_normal((E, HT, WD, 196)).astype(np.float32)
    flow = (3.0 * rng.standard_normal((E, HT, WD, 4))).astype(np.float32)
    ix = np.array([0, 1, 1])
    return img, net, inp, corr, flow, ix


def _models(weights, dtype):
    params, sd, _ = weights
    jm = JaxDroidNet(dtype=jnp.float32 if dtype == torch.float32 else jnp.bfloat16)
    tm = tdn.DroidNet()
    tm.load_state_dict(sd)
    return jm, params, tm.to(dtype).eval()


def _close(got, ref, dtype):
    got = got.float().numpy()
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    atol = 1e-4 if dtype == torch.float32 else BF16_REL * (np.abs(ref).max() + 1e-6)
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol)


DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("dtype", DTYPES)
def test_encode_features(weights, inputs, dtype):
    jm, params, tm = _models(weights, dtype)
    img = inputs[0]
    ref = jax.jit(lambda p, x: jm.apply(p, x, method=jm.encode_features))(params, jnp.asarray(img))
    with torch.no_grad():
        got = tm.encode_features(torch.from_numpy(img))
    assert got.dtype == dtype and tuple(got.shape) == (2, HT, WD, 128)
    _close(got, ref, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_encode_context(weights, inputs, dtype):
    jm, params, tm = _models(weights, dtype)
    img = inputs[0]
    net_j, inp_j = jax.jit(lambda p, x: jm.apply(p, x, method=jm.encode_context))(
        params, jnp.asarray(img))
    with torch.no_grad():
        net_t, inp_t = tm.encode_context(torch.from_numpy(img))
    _close(net_t, net_j, dtype)
    _close(inp_t, inp_j, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_update_with_graph_agg(weights, inputs, dtype):
    jm, params, tm = _models(weights, dtype)
    _, net, inp, corr, flow, ix = inputs
    ref = jax.jit(lambda p, *a: jm.apply(p, *a, 3, method=lambda m, *b: m.update(*b)))(
        params, *map(jnp.asarray, (net, inp, corr, flow, ix)))
    with torch.no_grad():
        got = tm.update(*map(torch.from_numpy, (net, inp, corr, flow, ix)), 3)
    assert len(got) == len(ref) == 4
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32
        _close(g, r, dtype)
    assert tuple(got[3].shape) == (3, HT, WD)


def test_update_without_graph_agg(weights, inputs):
    jm, params, tm = _models(weights, torch.float32)
    _, net, inp, corr, flow, _ = inputs
    ref = jax.jit(lambda p, *a: jm.apply(p, *a, method=lambda m, *b: m.update(*b)))(
        params, *map(jnp.asarray, (net, inp, corr, flow)))
    with torch.no_grad():
        got = tm.update(*map(torch.from_numpy, (net, inp, corr, flow)))
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        _close(g, r, torch.float32)


def test_state_dict_round_trip(weights):
    """Port state dict → ``convert_droidnet`` gives back the flax tree exactly."""
    _, sd, params_np = weights
    back = convert_droidnet({k: v.numpy() for k, v in sd.items()})
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params_np)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params_np)):
        np.testing.assert_array_equal(a, b)


def test_state_dict_layout_is_vipe(weights):
    _, sd, _ = weights
    tm = tdn.DroidNet()
    assert set(sd) == set(tm.state_dict())
    for key in ("fnet.layer1.0.conv1.weight", "update.corr_encoder.0.weight",
                "update.gru.convz.weight", "update.agg.eta.0.weight",
                "cnet.layer2.0.downsample.0.weight"):
        assert key in sd
    assert tuple(sd["update.delta.2.weight"].shape) == (2, 128, 3, 3)


def test_checkpoint_heads_cut_to_two(weights):
    """A ViPE ``droid.pth`` carries 3-channel delta/weight heads and keys
    the port has no module for; loading keeps the first 2 channels."""
    _, sd, _ = weights
    ckpt = {f"module.{k}": v for k, v in sd.items()}
    for head in ("update.delta.2", "update.weight.2"):
        w, b = sd[f"{head}.weight"], sd[f"{head}.bias"]
        ckpt[f"module.{head}.weight"] = torch.cat([w, w[:1]])
        ckpt[f"module.{head}.bias"] = torch.cat([b, b[:1]])
    ckpt["module.update.mask.0.weight"] = torch.zeros(1)
    tm = tdn.load_checkpoint_(tdn.DroidNet(), ckpt)
    for k, v in tm.state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0)


def test_seeded_init_is_reproducible(tmp_path, monkeypatch):
    monkeypatch.setenv("VIPE_WEIGHTS_DIR", str(tmp_path))  # no droid.pth: random init
    a = tdn.build_droidnet("cpu", dtype=torch.float32, seed=3).state_dict()
    b = tdn.build_droidnet("cpu", dtype=torch.float32, seed=3).state_dict()
    c = tdn.build_droidnet("cpu", dtype=torch.float32, seed=4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["fnet.conv1.weight"], c["fnet.conv1.weight"])
