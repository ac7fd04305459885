"""The port's layer routing (``ops/envelope.py``) against the JAX package's
predicates, and the route each preset's layers take.

The JAX package runs a conv block as one fused Pallas kernel when
``conv_norm_act_supported`` / ``conv_transpose_norm_act_supported`` hold,
else as the XLA conv followed by ``norm_act``, whose GroupNorm goes to the
``group_norm_act`` kernel when ``group_norm_act_supported`` holds. The port
must route every layer the same way. Layer shapes come from the port's own
models run on the meta device (no compute), at two batch sizes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from action_conditioned_gans_tpu.ops import pallas as P
from action_conditioned_gans_tpu_torch.config import PRESETS, get_preset
from action_conditioned_gans_tpu_torch.models import Discriminator, Generator
from action_conditioned_gans_tpu_torch.ops import api, envelope
from action_conditioned_gans_tpu_torch.ops.common import same_pad

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def preset_layers(preset, dtype, batch, **model_kw):
    """(name, block, x shape, output shape) of every G and D layer of
    ``preset`` in ``dtype`` (and ``model_kw``), as the models call them."""
    m = dataclasses.replace(get_preset(preset).model, compute_dtype=dtype, **model_kw)
    with torch.device("meta"):
        models = {"G": Generator(m), "D": Discriminator(m)}
    s = m.image_size
    frame = torch.empty(batch, s, s, m.image_channels, device="meta")
    action = torch.empty(batch, m.action_dim, device="meta")
    state = torch.empty(batch, m.state_dim, device="meta") if m.state_dim else None
    seen = []
    for prefix, model in models.items():
        hooks = [
            block.register_forward_hook(
                lambda mod, args, out, name=f"{prefix}.{name}": seen.append(
                    (name, mod, tuple(args[0].shape), tuple(out.shape)))
            )
            for name, block in model.named_children()
        ]
        with torch.no_grad():
            if prefix == "G":
                model(frame, action, state)
            else:
                model(frame, frame, action, state)
        for h in hooks:
            h.remove()
    return seen


def jax_route(block, x_shape, out_shape, dtype):
    """(route, kernel 3 runs) as the JAX package's api.conv_norm_act
    decides them with backend="pallas"."""
    x = jax.ShapeDtypeStruct(x_shape, jnp.dtype(dtype))
    w = jax.ShapeDtypeStruct(tuple(block.kernel.shape), jnp.float32)
    fits = P.conv_transpose_norm_act_supported if block.transpose else P.conv_norm_act_supported
    if fits(x, w, block.stride, block.norm, block.groups):
        return "fused", False
    y = jax.ShapeDtypeStruct(out_shape, jnp.dtype(dtype))
    return "split", block.norm == "group" and P.group_norm_act_supported(y, block.groups)


@pytest.mark.parametrize("batch", [1, 32])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_route_matches_jax_for_every_layer(preset, dtype, batch):
    layers = preset_layers(preset, dtype, batch)
    assert len(layers) >= 11
    for name, block, x_shape, out_shape in layers:
        want, k3 = jax_route(block, x_shape, out_shape, dtype)
        got = envelope.route(x_shape, tuple(block.kernel.shape), block.stride, block.transpose,
                             block.norm, block.groups, DTYPES[dtype])
        assert got == want, (name, x_shape)
        if want == "split" and block.norm == "group":
            # No preset layer is off kernel 3's own envelope.
            assert k3 and envelope.group_norm_act_supported(out_shape), (name, out_shape)


# The split layers of each preset (norm-free ones marked), as PERF.md and
# ROADMAP.md record them. Every other layer is fused.
SPLIT = {
    ("config1", "bfloat16"): [],
    ("config1", "float32"): ["D.conv_3"],
    ("config2", "bfloat16"): [],
    ("config2", "float32"): ["D.conv_3"],
    ("config3", "bfloat16"): ["D.conv_4"],
    ("config3", "float32"): ["G.enc_3", "G.bottleneck", "G.dec_3", "D.conv_3", "D.conv_3_extra_0",
                             "D.conv_4", "D.conv_4_extra_0"],
    ("config4", "bfloat16"): [],
    ("config4", "float32"): ["D.conv_3"],
    ("config5", "bfloat16"): ["G.enc_0 (none)", "G.enc_1", "G.enc_3", "G.enc_4", "G.dec_4",
                              "G.dec_3", "G.dec_2", "G.dec_1", "G.dec_0 (none)",
                              "D.conv_0 (none)", "D.conv_0_extra_0", "D.conv_1",
                              "D.conv_1_extra_0", "D.conv_3", "D.conv_3_extra_0", "D.conv_4",
                              "D.conv_5"],
    ("config5", "float32"): ["G.enc_0 (none)", "G.enc_1", "G.enc_2", "G.enc_3", "G.enc_4",
                             "G.bottleneck", "G.dec_4", "G.dec_3", "G.dec_2", "G.dec_1",
                             "G.dec_0 (none)", "D.conv_0 (none)", "D.conv_0_extra_0", "D.conv_1",
                             "D.conv_1_extra_0", "D.conv_2", "D.conv_2_extra_0", "D.conv_3",
                             "D.conv_3_extra_0", "D.conv_4", "D.conv_4_extra_0", "D.conv_5",
                             "D.conv_5_extra_0"],
}


@pytest.mark.parametrize("preset,dtype", sorted(SPLIT))
def test_split_layers_per_preset(preset, dtype):
    api.reset_routes()
    layers = preset_layers(preset, dtype, batch=2)
    split = [name + ("" if block.norm == "group" else " (none)")
             for name, block, x_shape, _ in layers
             if envelope.route(x_shape, tuple(block.kernel.shape), block.stride, block.transpose,
                               block.norm, block.groups, DTYPES[dtype]) == "split"]
    assert split == SPLIT[(preset, dtype)]
    # The dispatch counted each layer once, on the route the table gives.
    assert api.ROUTES == {**dict.fromkeys(api.ROUTES, 0), "fused": len(layers) - len(split),
                           "split": len(split)}


# The split convs that still write out a padded input: those on an odd
# plane, which SAME pads (1, 2). No preset has one (its planes halve from
# 64, 128 or 256); config1 at 56x56 gives D conv_3 a 7x7 input.
PAD_COPY = {("config1", "float32", 56): ["D.conv_3"]}


@pytest.mark.parametrize("preset,dtype,size", [
    (p, d, None) for p in sorted(PRESETS) for d in sorted(DTYPES)] + [("config1", "float32", 56)])
def test_split_convs_that_write_out_their_pad(preset, dtype, size):
    api.reset_routes()
    layers = preset_layers(preset, dtype, batch=2, **({"image_size": size} if size else {}))
    padded = []
    for name, block, x_shape, _ in layers:
        route = envelope.route(x_shape, tuple(block.kernel.shape), block.stride, block.transpose,
                               block.norm, block.groups, DTYPES[dtype])
        pads = [same_pad(n, k, block.stride)[1:] for n, k in zip(x_shape[1:3], block.kernel.shape)]
        if route == "split" and not block.transpose and any(lo != hi for lo, hi in pads):
            padded.append(name)
    assert padded == PAD_COPY.get((preset, dtype, size), [])
    assert api.ROUTES["pad_copy"] == len(padded)
    assert api.ROUTES["split"] >= len(padded)


EDGE_CONV = [
    # x shape, w shape, stride
    ((2, 9, 9, 5), (4, 4, 5, 12), 2),  # odd plane, stride 2: SAME pads (1, 2)
    ((2, 7, 5, 3), (3, 3, 3, 8), 1),  # odd, non-square plane, stride 1
    ((2, 7, 5, 3), (3, 3, 3, 8), 2),  # odd plane, odd kernel, stride 2: padded plane odd
    ((2, 8, 8, 16), (4, 4, 8, 16), 2),  # wcin != cin
    ((2, 8, 8, 16), (4, 3, 16, 16), 2),  # non-square kernel
    ((2, 8, 8, 16), (4, 4, 16, 16), 3),  # stride 3
    ((2, 8, 8, 16), (1, 1, 16, 16), 1),  # 1x1
    ((2, 32, 32, 256), (4, 4, 256, 512), 2),  # D conv_3 of config1: bf16 fits, f32 not
    ((2, 64, 64, 64), (4, 4, 64, 128), 2),  # config5 G enc_1: off in both dtypes
    ((2, 8, 8, 512), (3, 3, 516, 512), 1),  # wcin != cin at bottleneck size
    ((2, 5, 6, 6), (4, 4, 6, 8), 2),  # transposable, odd plane
    ((2, 8, 8, 512), (4, 4, 512, 512), 2),  # config3 G dec_3: bf16 fits, f32 not
    ((4, 8), (4, 4, 8, 8), 2),  # not NHWC
]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("x_shape,w_shape,stride", EDGE_CONV)
def test_conv_predicates_match_jax_on_edge_shapes(x_shape, w_shape, stride, dtype):
    x = jax.ShapeDtypeStruct(x_shape, jnp.dtype(dtype))
    w = jax.ShapeDtypeStruct(w_shape, jnp.float32)
    for kind in ("group", "none", "batch"):
        assert envelope.conv_norm_act_supported(x_shape, w_shape, stride, kind, DTYPES[dtype]) == (
            P.conv_norm_act_supported(x, w, stride, kind, 32)), kind
        assert envelope.conv_transpose_norm_act_supported(
            x_shape, w_shape, stride, kind, DTYPES[dtype]
        ) == P.conv_transpose_norm_act_supported(x, w, stride, kind, 32), kind


@pytest.mark.parametrize("shape", [
    (2, 8, 8, 16), (2, 8, 8, 31), (2, 8, 8, 32), (2, 7, 5, 40), (2, 9, 9, 96), (2, 4, 4, 520),
    (2, 128, 128, 64), (2, 128, 128, 80), (2, 128, 128, 81), (2, 256, 256, 32), (4, 8, 8),
])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_group_norm_act_envelope_matches_jax(shape, dtype):
    # 128*128*80 float32 twice is exactly the 10 MiB budget; 81 channels is over.
    x = jax.ShapeDtypeStruct(shape, jnp.dtype(dtype))
    assert envelope.group_norm_act_supported(shape) == P.group_norm_act_supported(x, 32)

