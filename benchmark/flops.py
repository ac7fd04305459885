"""Closed-form operation and byte counts, from a configuration's layer geometry.

The yardstick of the benchmark's rate-based shares: nothing here imports
the program. A model's FLOPs are those of its convolutions and matrix
products, counted as ``torch.utils.flop_counter`` counts ``aten.convolution``
(2 * batch * the output's pixels * kh * kw * Cin * Cout; a conv-transpose
counts its input's pixels), its backward (the same again for each of the
input and weight gradients that the step needs) and ``aten.mm``. Norms,
activations, losses and Adam are not counted. A step's count leaves out
the generator forward that ``remat_rollout`` recomputes in the backward:
the model's FLOPs, not the program's.

The byte and operation counts of kernels 1-4, which the trace reader holds
each launch's time to, are here too (``conv_cost``, ``gn_cost``,
``gn_bwd_cost``): each input read once and each output written once.
"""

from __future__ import annotations

import dataclasses
from typing import List, Mapping, Tuple

# NVIDIA H100 SXM data sheet, dense rates, at the card's 700 W limit.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


@dataclasses.dataclass(frozen=True)
class Conv:
    """One conv block: k x k, ``stride``, ``cin`` -> ``cout`` channels, a
    square ``size_in`` -> ``size_out`` image; ``transpose`` for the
    decoder's conv-transposes."""

    name: str
    transpose: bool
    k: int
    stride: int
    cin: int
    cout: int
    size_in: int
    size_out: int

    def flops(self, batch: int) -> int:
        pixels = self.size_in if self.transpose else self.size_out
        return 2 * batch * pixels * pixels * self.k * self.k * self.cin * self.cout


def channels_at(level: int, base: int, cap: int) -> int:
    return min(base * 2**level, cap)


def _cond_dim(m: Mapping) -> int:
    return m["action_dim"] + m.get("state_dim", 0)


def generator_layers(m: Mapping) -> List[Conv]:
    """The generator's blocks in call order: the stride-2 encoder, the 3x3
    bottleneck over the tiled action, the conv-transpose decoder."""
    layers, ch, size = [], m["image_channels"], m["image_size"]
    base, cap, levels = m["g_base_channels"], m["g_max_channels"], m["g_levels"]
    for i in range(levels):
        out = channels_at(i, base, cap)
        layers.append(Conv(f"enc_{i}", False, 4, 2, ch, out, size, -(-size // 2)))
        ch, size = out, -(-size // 2)
    bott = channels_at(levels - 1, base, cap)
    layers.append(Conv("bottleneck", False, 3, 1, ch + _cond_dim(m), bott, size, size))
    ch = bott
    for i in reversed(range(levels)):
        if m.get("skip_connections"):
            ch += channels_at(i, base, cap)
        out = m["image_channels"] if i == 0 else channels_at(i - 1, base, cap)
        layers.append(Conv(f"dec_{i}", True, 4, 2, ch, out, size, 2 * size))
        ch, size = out, 2 * size
    return layers


def discriminator_layers(m: Mapping) -> Tuple[List[Conv], int]:
    """The discriminator's blocks in call order and the width of its dense
    logit's input."""
    ch = m["image_channels"]
    if m["d_condition_frame"]:
        ch += m["image_channels"]
    if m["d_condition_action"]:
        ch += _cond_dim(m)
    layers, size = [], m["image_size"]
    for i in range(m["d_levels"]):
        out = channels_at(i, m["d_base_channels"], m["d_max_channels"])
        layers.append(Conv(f"conv_{i}", False, 4, 2, ch, out, size, -(-size // 2)))
        ch, size = out, -(-size // 2)
        for j in range(m["d_extra_layers"]):
            layers.append(Conv(f"conv_{i}_extra_{j}", False, 3, 1, ch, ch, size, size))
    return layers, size * size * ch


def generator_forward_flops(m: Mapping, batch: int) -> int:
    """One generator call over ``batch`` frames."""
    return sum(layer.flops(batch) for layer in generator_layers(m))


def step_flops(cfg: Mapping) -> int:
    """One fused G+D training step of ``cfg`` (the configuration file's
    ``config``): G's forward over the B*T transitions; ``disc_steps`` times
    D's forward over real and fake (2N) and its backward, weight gradients
    of every layer and input gradients of all but ``conv_0``, whose input
    needs none; D's forward over the predictions and its input gradients
    alone (D is frozen there); G's backward, both gradients of every layer
    but ``enc_0``'s input, which needs one only after a scheduled-sampling
    rollout's first step. Steps without D microbatching or R1."""
    m, t = cfg["model"], cfg["train"]
    if t.get("r1_weight", 0) > 0 or t.get("disc_microbatch", 0) > 0:
        raise ValueError("step_flops counts steps without R1 and D microbatching")
    n = t["batch_size"] * max(t["rollout_length"], 1)
    g = generator_layers(m)
    d, features = discriminator_layers(m)
    g_fwd = sum(layer.flops(n) for layer in g)
    g_bwd = 2 * g_fwd - g[0].flops(n)
    if t.get("scheduled_sampling"):
        # Steps after the first may take the previous prediction as input.
        g_bwd += g[0].flops(t["batch_size"] * (max(t["rollout_length"], 1) - 1))

    def d_convs(batch):
        return sum(layer.flops(batch) for layer in d)

    def dense(batch):
        return 2 * batch * features

    d_step = (d_convs(2 * n) + dense(2 * n)) + (2 * d_convs(2 * n) - d[0].flops(2 * n)) + 2 * dense(2 * n)
    g_head = d_convs(n) + dense(n) + d_convs(n) + dense(n)
    return g_fwd + g_bwd + max(t.get("disc_steps", 1), 1) * d_step + g_head


# -- kernels 1-4: operations and bytes of one call --------------------------------------


def _peak(itemsize: int) -> float:
    return PEAK_BF16_FLOPS if itemsize == 2 else PEAK_F32_FLOPS


def bound_s(flops: float, nbytes: float, flops_peak: float) -> float:
    """The least time of a call: its operations at the peak or its bytes at
    the memory rate, whichever is longer."""
    return max(flops / flops_peak, nbytes / PEAK_BYTES)


def conv_cost(b: int, h: int, w: int, cin: int, k: int, cout: int, stride: int,
              transpose: bool, itemsize: int) -> float:
    """Kernels 1 and 2: a SAME conv (stride 1 or 2) or a k=4 / stride-2
    conv-transpose over (b, h, w, cin) with the GroupNorm epilogue; x and w
    read, the output written, in the compute dtype, and the scale and bias
    read in float32. Returns the bound in seconds."""
    if transpose:
        oh, ow = 2 * h, 2 * w
        flops = 2 * b * h * w * k * k * cin * cout
    else:
        oh, ow = -(-h // stride), -(-w // stride)
        flops = 2 * b * oh * ow * k * k * cin * cout
    nbytes = (b * h * w * cin + k * k * cin * cout + b * oh * ow * cout) * itemsize + 2 * cout * 4
    return bound_s(flops, nbytes, _peak(itemsize))


def gn_cost(b: int, h: int, w: int, c: int, itemsize: int) -> float:
    """Kernel 3: GroupNorm -> affine -> activation over (b, h, w, c): about
    10 float32 operations an element, x read and the output written."""
    n = b * h * w * c
    return bound_s(10 * n, 2 * n * itemsize + 8 * c, PEAK_F32_FLOPS)


def gn_bwd_cost(b: int, h: int, w: int, c: int, itemsize: int, y_itemsize: int) -> float:
    """Kernel 4: GroupNorm + activation backward over (b, h, w, c): about 12
    float32 operations an element; y (``y_itemsize``), out and the incoming
    gradient read, dy written, and the per-channel sums."""
    n = b * h * w * c
    return bound_s(12 * n, n * (y_itemsize + 3 * itemsize) + 12 * c, PEAK_F32_FLOPS)
