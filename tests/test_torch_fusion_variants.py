"""The global-feature fusions, the MLP head and the SpatialReshaper of the
PyTorch port against the JAX package, on the same seeded weights carried
over by `load_jax_variables`.

f32 on the CPU with jax_default_matmul_precision="highest" (conftest).
Limit: 1e-5 of each output's largest magnitude. The modules are a few dense
layers deep; the attention's LayerNorms differ only in the variance formula
(flax's E[x^2] - E[x]^2 against torch's two-pass), which moves O(1) outputs
by ~1e-7. The modality sets are those of tests/test_fusion_and_heads.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevfusion_multimodal_3d_object_detection_tpu import config as jax_config
from bevfusion_multimodal_3d_object_detection_tpu.models import fusion as jax_fusion
from bevfusion_multimodal_3d_object_detection_tpu.models import heads as jax_heads
from bevfusion_multimodal_3d_object_detection_tpu_torch.models import fusion as port_fusion
from bevfusion_multimodal_3d_object_detection_tpu_torch.models import heads as port_heads
from bevfusion_multimodal_3d_object_detection_tpu_torch.utils.convert import (
    export_jax_variables,
    load_jax_variables,
)
from torch_port_helpers import random_variables, to_port_spec

KEY = jax.random.PRNGKey(0)
COMBOS = [
    (True, False, False),
    (False, True, False),
    (False, False, True),
    (True, True, False),
    (True, False, True),
    (False, True, True),
    (True, True, True),
]
COMBO_IDS = ["c", "l", "r", "cl", "cr", "lr", "clr"]
ATTENTION = jax_config.AttentionFusionSpec(hidden_dim=64, num_heads=2, num_layers=2)
LATE = jax_config.LateFusionSpec(output_dim=48, hidden_dim=96)


def _features(combo, b=2, seed=0):
    """NHWC camera features (B, 6, 4, 8, 512), LiDAR (B, 1024), radar (B, 256)."""
    rng = np.random.RandomState(seed)
    cam = rng.randn(b, 6, 4, 8, 512).astype(np.float32)
    lidar = rng.randn(b, 1024).astype(np.float32)
    radar = rng.randn(b, 256).astype(np.float32)
    return tuple(x if on else None for x, on in zip((cam, lidar, radar), combo))


def _jax(x):
    return None if x is None else jnp.asarray(x)


def _torch(x, camera=False):
    if x is None:
        return None
    t = torch.from_numpy(x)
    return t.permute(0, 1, 4, 2, 3) if camera else t  # NHWC views -> NCHW views


def _assert_close(got, want, what=""):
    want = np.asarray(want)
    assert got.shape == want.shape, what
    if want.size == 0:
        return
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max(), err_msg=what)


def _parity(jax_mod, port_mod, feats, seed=1):
    variables = random_variables(jax_mod.init({"params": KEY}, *map(_jax, feats)), seed)
    want = jax_mod.apply(variables, *map(_jax, feats))
    load_jax_variables(port_mod, variables).eval()
    with torch.no_grad():
        got = port_mod(_torch(feats[0], camera=True), _torch(feats[1]), _torch(feats[2]))
    return got.numpy(), np.asarray(want), variables


@pytest.mark.parametrize("combo", COMBOS, ids=COMBO_IDS)
def test_attention_fusion(combo):
    jax_mod = jax_fusion.FlexibleAttentionFusion(spec=ATTENTION, use_camera=combo[0], use_lidar=combo[1],
                                                 use_radar=combo[2])
    port_mod = port_fusion.FlexibleAttentionFusion(to_port_spec(ATTENTION), *combo)
    got, want, variables = _parity(jax_mod, port_mod, _features(combo))
    assert got.shape == want.shape == (2, 64)
    _assert_close(got, want)
    # the tree comes back out leaf for leaf, positional embeddings included
    back = export_jax_variables(port_mod)["params"]
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(variables["params"])
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(variables["params"])):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("combo", COMBOS, ids=COMBO_IDS)
def test_late_fusion(combo):
    jax_mod = jax_fusion.FlexibleLateFusion(spec=LATE, use_camera=combo[0], use_lidar=combo[1],
                                            use_radar=combo[2])
    port_mod = port_fusion.FlexibleLateFusion(to_port_spec(LATE), *combo)
    got, want, _ = _parity(jax_mod, port_mod, _features(combo))
    assert got.shape == want.shape == (2, 48)
    _assert_close(got, want)


def test_cross_modal_attention():
    """The attention alone, with more keys than queries and 4 heads: the
    head split, the scaling after the product; num_heads must divide dim."""
    rng = np.random.RandomState(3)
    q, k = rng.randn(2, 3, 64).astype(np.float32), rng.randn(2, 5, 64).astype(np.float32)
    jax_mod = jax_fusion.CrossModalAttention(dim=64, num_heads=4)
    variables = random_variables(jax_mod.init({"params": KEY}, jnp.asarray(q), jnp.asarray(k), jnp.asarray(k)), 2)
    port_mod = load_jax_variables(port_fusion.CrossModalAttention(64, 4), variables).eval()
    want = jax_mod.apply(variables, jnp.asarray(q), jnp.asarray(k), jnp.asarray(k))
    with torch.no_grad():
        got = port_mod(*map(torch.from_numpy, (q, k, k)))
    _assert_close(got.numpy(), want)
    with pytest.raises(ValueError, match="divide"):
        port_fusion.CrossModalAttention(64, 5)


def test_layer_norm_epsilon_is_flax_default():
    """flax's LayerNorm epsilon is 1e-6 (torch's default 1e-5). With the
    token projections, embeddings and first attention scaled by 1e-3 the
    first LayerNorm's input has a variance of ~1e-6, where the epsilon
    decides the normalization: the port holds 1e-5 of the output, a copy
    with torch's epsilon misses by orders of magnitude."""
    combo = (False, True, True)
    jax_mod = jax_fusion.FlexibleAttentionFusion(spec=ATTENTION, use_camera=False)
    port_mod = port_fusion.FlexibleAttentionFusion(to_port_spec(ATTENTION), *combo)
    norms = [m for m in port_mod.modules() if isinstance(m, torch.nn.LayerNorm)]
    assert len(norms) == 4 and all(m.eps == 1e-6 for m in norms)
    feats = _features(combo)
    variables = random_variables(jax_mod.init({"params": KEY}, *map(_jax, feats)), 1)

    def small(path, leaf):
        name = path[0].key
        return leaf * np.float32(1e-3) if name.startswith(("lidar_", "radar_", "self_attn_0")) else leaf

    variables = {"params": jax.tree_util.tree_map_with_path(small, variables["params"])}
    want = np.asarray(jax_mod.apply(variables, *map(_jax, feats)))
    load_jax_variables(port_mod, variables).eval()
    with torch.no_grad():
        got = port_mod(None, _torch(feats[1]), _torch(feats[2])).numpy()
        _assert_close(got, want)
        for m in norms:
            m.eps = 1e-5
        mutant = port_mod(None, _torch(feats[1]), _torch(feats[2])).numpy()
    assert np.abs(mutant - want).max() > 100 * 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("batch_shape", [(3,), (2, 5, 6)], ids=["global", "bev_map"])
def test_mlp_head(batch_shape):
    """(B, C) -> cls/box. On a 4-D map (``fusion_type: bev`` with the MLP
    head) the JAX head slices axis 1 of NHWC, the BEV rows: the port gives
    the same arrays."""
    spec = jax_config.MLPHeadSpec(hidden_dim=32)
    x = np.random.RandomState(4).randn(*batch_shape, 24).astype(np.float32)
    jax_mod = jax_heads.MLPDetectionHead(spec=spec)
    variables = random_variables(jax_mod.init({"params": KEY}, jnp.asarray(x)), 5)
    want = jax_mod.apply(variables, jnp.asarray(x))
    port_mod = load_jax_variables(port_heads.MLPDetectionHead(to_port_spec(spec), 24), variables).eval()
    with torch.no_grad():
        xt = torch.from_numpy(x)
        got = port_mod(xt.permute(0, 3, 1, 2) if x.ndim == 4 else xt)  # the port's maps are NCHW
    assert set(got) == {"cls", "box"}
    for k in got:
        assert tuple(got[k].shape) == want[k].shape, k
        _assert_close(got[k].numpy(), want[k], k)
    if x.ndim == 4:
        assert want["cls"].shape == (2, 5, 6, 17) and want["box"].shape == (2, 0, 6, 17)


def test_mlp_head_init():
    head = port_heads.MLPDetectionHead(to_port_spec(jax_config.MLPHeadSpec()), 512)
    head.reset_parameters(torch.Generator().manual_seed(0))
    assert abs(float(head.fc1.weight.detach().std()) - 512 ** -0.5) < 0.05 * 512 ** -0.5
    assert not head.fc1.bias.any() and not head.fc2.bias.any()


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_spatial_reshaper(train):
    """Eval, and train mode with BatchNorm batch statistics and flax's
    running-statistics update; a 4-D input passes through."""
    x = np.random.RandomState(6).randn(2, 40).astype(np.float32)
    jax_mod = jax_fusion.SpatialReshaper(output_channels=16, bev_h=6, bev_w=5)
    variables = random_variables(jax_mod.init({"params": KEY}, jnp.asarray(x)), 7)
    port_mod = load_jax_variables(port_fusion.SpatialReshaper(40, 16, 6, 5), variables)
    port_mod.train(train)
    if train:
        want, mutated = jax_mod.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    else:
        want = jax_mod.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = port_mod(torch.from_numpy(x))
    _assert_close(got.permute(0, 2, 3, 1).numpy(), want)
    if train:
        stats = export_jax_variables(port_mod)["batch_stats"]
        for path, v in jax.tree_util.tree_leaves_with_path(mutated["batch_stats"]):
            mine = stats
            for p in path:
                mine = mine[p.key]
            np.testing.assert_allclose(mine, np.asarray(v), rtol=1e-5, atol=1e-6, err_msg=str(path))
    m = torch.randn(2, 16, 6, 5)
    assert port_mod(m) is m


def test_dropout_is_live_in_training_at_jax_rates():
    """Train mode drops at the JAX modules' rates: attention 0.1 (its
    weights, feed-forward and output), late fusion 0.3 and the fixed 0.1 of
    fusion.py:473, the MLP head 0.1. Each dropout's zeroed share lies within
    5 binomial standard deviations of its rate, and every survivor is its
    input scaled by 1/(1 - p). Eval mode drops nothing."""
    torch.manual_seed(0)
    attention = port_fusion.FlexibleAttentionFusion(
        to_port_spec(jax_config.AttentionFusionSpec()), True, True, True)
    late = port_fusion.FlexibleLateFusion(to_port_spec(jax_config.LateFusionSpec()))
    head = port_heads.MLPDetectionHead(to_port_spec(jax_config.MLPHeadSpec()), 512)
    rates = {id(attention.dropout): 0.1, id(attention.self_attn_0.dropout): 0.1,
             id(attention.self_attn_1.dropout): 0.1, id(late.dropout1): 0.3, id(late.dropout2): 0.1,
             id(head.dropout): 0.1}
    seen = {}

    def hook(mod, inputs, output):
        seen.setdefault(id(mod), []).append((inputs[0].detach(), output.detach()))

    for mod in (attention, late, head):
        for m in mod.modules():
            if isinstance(m, torch.nn.Dropout):
                assert m.p == rates[id(m)]
                m.register_forward_hook(hook)
    b = 512
    feats = (torch.randn(b, 6, 512, 4, 8), torch.randn(b, 1024), torch.randn(b, 256))
    for train in (True, False):
        seen.clear()
        for mod in (attention, late, head):
            mod.train(train)
        with torch.no_grad():
            attention(*feats)
            head(late(*feats))
        assert set(seen) == set(rates)
        for key, calls in seen.items():
            x = torch.cat([i.flatten() for i, _ in calls])
            y = torch.cat([o.flatten() for _, o in calls])
            live = x != 0
            dropped = (y == 0) & live
            p = rates[key] if train else 0.0
            n = int(live.sum())
            share = float(dropped.sum()) / n
            assert abs(share - p) <= 5 * np.sqrt(p * (1 - p) / n) + 1e-12, (key, share, p)
            kept = ~dropped & live
            torch.testing.assert_close(y[kept], x[kept] / (1 - p), rtol=1e-6, atol=0)
