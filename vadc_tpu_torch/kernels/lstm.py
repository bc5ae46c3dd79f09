"""Multi-layer LSTM over a whole sequence as one CUDA kernel.

Counterpart of vadc_tpu/kernels/lstm.py (`lstm_fused`, the kernel form of
nn.functional.lstm). The kernel is `csrc/lstm.cu` in two variants that give
the same bits, streaming weights for one or two steps and resident weights
(`csrc/lstm_resident.cuh`) for more; the headers say what bounds each on an
H100 and how its design answers that, and `use_resident` here chooses
between them from the shapes alone. The v4 (L=2, H=64) and v5 (L=1, H=128)
forwards run it: at batch B with T frames per chunk in `forward`, and at
batch 1 over the N chunks' frames flattened into one sequence in
`forward_minibatched`.

Both variants have an instance of each precision tier (`nn.precision`),
each reading the weight as `weight_of(params, tier)` packs it: at faithful
the transposed fp32 weight and the CUDA cores' fmaf chains in k order; at
the bf16 tiers the gate sums on the tensor cores (`csrc/lstm_mma.cuh`:
mma.sync m16n8k16 from the A fragments `gate_fragments` packs, each k16
step from zero and added to the fp32 sum in order, the input steps, then
the recurrent ones, then the bias). Every site of a tier sums in one
order, so the two variants give the same bits at every tier;
`lstm_mma_reference` is that order in plain PyTorch. The tier's tanh, fp32
state. The JAX package's Pallas kernel sums at HIGHEST whatever the tier,
but its v4/v5 models run nn.functional.lstm, whose gates take the tier's
products: the instances compute that function, and the plain version is
`F.lstm(..., tier)`.
"""

from __future__ import annotations

import ctypes

import torch

from vadc_tpu_torch.kernels import _build
from vadc_tpu_torch.nn import functional as F
from vadc_tpu_torch.nn.precision import (
    FAITHFUL, Tier, bf16, matmul_at, pack_operand, split, tanh_at, tier_of,
)

#: hidden sizes the kernel is built for (v4: 64, v5: 128)
HIDDEN_SIZES = (64, 128)
#: (hidden, layers) the resident-weights variant is built for: v4's and v5's;
#: any other depth keeps the streaming-weights variant
RESIDENT_SHAPES = ((64, 2), (128, 1))


def transpose_weight(w: torch.Tensor) -> torch.Tensor:
    """Fused LSTM weight [L, 4H, 2H] -> the faithful kernels' [L, 2H, 4H],
    contiguous, so neighbouring threads (gate columns) read neighbouring
    weights. The tensor is marked with its products' mode (fp32), which
    `lstm_fused` holds to the tier it launches."""
    wt = w.transpose(1, 2).contiguous()
    wt._vadc_products = "fp32"
    return wt


def transposed_weight_of(params) -> torch.Tensor:
    """The faithful kernels' weight of a Params' LSTM, transposed once per
    Params (both recurrent kernels' faithful instances read it so)."""
    return params.derived("lstm_wt", lambda: transpose_weight(params["lstm_w"]))


def gate_fragments(w: torch.Tensor, mode: str) -> torch.Tensor:
    """The fused weight w [L, 4H, 2H] (rows the gates i, f, g, o; columns the
    H inputs, then the H recurrent units) as the bf16 tiers' tensor-core
    gate sums read it (csrc/lstm_mma.cuh): per layer, per plane (bf16(w),
    then at bf16_3x (mode) bf16(w - hi)), per gate tile m (rows r = 0..15:
    gate r // 4 of unit 4m + r % 4) and k16 step ks (the H/16 input steps,
    then the H/16 recurrent ones), the mma.sync A fragments of the 32 lanes
    (g = lane // 4, t = lane % 4): words (row g, columns 16 ks + 2t, + 1),
    (row g + 8, the same), (row g, + 8, + 9), (row g + 8, + 8, + 9), the
    lower column in a word's lower half. Returned as an fp32 tensor of the
    words' bits, [L, planes, H/4, 2H/16, 32, 4], marked with its mode."""
    layers, gates, width = w.shape
    hidden = width // 2
    if gates != 4 * hidden or hidden % 16:
        raise ValueError(f"gate_fragments: w {tuple(w.shape)} is not [L, 4H, 2H], H a multiple of 16")
    dev = w.device
    r, m = torch.arange(16, device=dev), torch.arange(hidden // 4, device=dev)
    rows = (r // 4)[None, :] * hidden + 4 * m[:, None] + (r % 4)[None, :]  # [tiles, 16]
    lane = torch.arange(32, device=dev)
    g, t = lane // 4, lane % 4
    row_of = torch.stack([g, g + 8, g, g + 8], dim=-1)  # [32, 4]
    col_of = torch.stack([2 * t, 2 * t, 2 * t + 8, 2 * t + 8], dim=-1)
    row_idx = rows[:, row_of][:, None]  # [tiles, 1, 32, 4]
    col_idx = (16 * torch.arange(width // 16, device=dev)[:, None, None] + col_of)[None]
    planes = list(split(w)) if mode == "bf16_3x" else [bf16(w)]
    words = []
    for plane in planes:
        bits = plane.contiguous().to(torch.bfloat16).view(torch.int16).to(torch.int32) & 0xFFFF
        low, high = bits[:, row_idx, col_idx], bits[:, row_idx, col_idx + 1]
        words.append(low | (high << 16))  # [L, tiles, steps, 32, 4]
    out = torch.stack(words, dim=1).contiguous().view(torch.float32)
    out._vadc_products = mode
    return out


def v31_gates_on_mma(tier: Tier | str) -> bool:
    """Whether the v3.1 LSTM (lstm_decoder_fused and the step kernels' LSTM,
    which give each other's bits) sums its gates on the tensor cores at the
    tier: balanced and fast. Turbo keeps the CUDA-core chains: on the
    tensor cores its lstm_decoder_fused probabilities broke tier_check's
    limit (csrc/lstm_mma.cuh: v31_gates_on_mma; PERF.md, PR 14).
    lstm_fused sums on the tensor cores at every bf16 tier."""
    return tier_of(tier).name in ("balanced", "fast")


def weight_of(params, tier: Tier | str = FAITHFUL, mma: bool = True) -> torch.Tensor:
    """What the tier's instances of the recurrent kernels read as `wt`,
    built once per Params: the transposed fp32 weight at faithful; at a bf16
    tier the gate fragments where the gates run on the tensor cores (`mma`;
    fast and turbo share them), else the transposed weight packed for the
    tier's products (nn.precision.pack_operand)."""
    tier = tier_of(tier)
    if tier.products == "fp32":
        return transposed_weight_of(params)
    key = f"lstm_frags_{tier.products}" if mma else f"lstm_wt_{tier.products}"
    return params.derived(key, lambda: kernel_weight(params["lstm_w"], tier, mma))


def kernel_weight(w: torch.Tensor, tier: Tier, mma: bool = True) -> torch.Tensor:
    """weight_of's tensor for a bare weight w [L, 4H, 2H]."""
    if tier.products == "fp32":
        return transpose_weight(w)
    if mma:
        return gate_fragments(w, tier.products)
    wt = pack_operand(w.transpose(1, 2).contiguous(), tier.products)
    wt._vadc_products = tier.products
    return wt


def weight_shape(layers: int, hidden: int, tier: Tier, mma: bool = True) -> tuple:
    """The shape of `kernel_weight` at the tier."""
    if tier.products == "fp32" or not mma:
        return (layers, 2 * hidden, 4 * hidden)
    planes = 2 if tier.products == "bf16_3x" else 1
    return (layers, planes, hidden // 4, hidden // 8, 32, 4)


def lstm_fused_reference(
    x: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
    tier: Tier | str = FAITHFUL,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version: nn.functional.lstm at the tier. x [B, T, H]; h0, c0
    [L, B, H]; w [L, 4H, 2H]; b [L, 4H] -> (y [B, T, H], hn, cn)."""
    return F.lstm(x, h0, c0, w, b, tier_of(tier))


def lstm_hoisted_reference(
    x: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
    tier: Tier | str = FAITHFUL,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version in the resident variant's order: per layer, the input
    gate sums of ALL frames first (x . rows 0..H-1 of the layer's transposed
    weight), then the recurrence from them (+ h . rows H..2H-1, + bias; gate
    order i, f, g, o); the products and tanh at the tier. Shapes as
    `lstm_fused_reference`."""
    tier = tier_of(tier)
    hidden = x.shape[-1]
    wt = transpose_weight(w)
    seq, hn, cn = x, [], []
    for layer in range(wt.shape[0]):
        pre = matmul_at(seq, wt[layer, :hidden], tier.products)  # [B, T, 4H]
        w_rec = wt[layer, hidden:]
        h, c = h0[layer], c0[layer]
        outs = []
        for t in range(seq.shape[1]):
            gates = pre[:, t] + matmul_at(h, w_rec, tier.products) + b[layer]
            i, f, g, o = gates.chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * tanh_at(g, tier)
            h = torch.sigmoid(o) * tanh_at(c, tier)
            outs.append(h)
        seq = torch.stack(outs, dim=1)
        hn.append(h)
        cn.append(c)
    return seq, torch.stack(hn), torch.stack(cn)


def mma_sum(a: torch.Tensor, wt: torch.Tensor, mode: str, acc: torch.Tensor | None = None
            ) -> torch.Tensor:
    """acc + a @ wt in the tensor-core order of csrc/lstm_mma.cuh: the
    product of each k16 step of a's last axis from zero (at bf16_3x lo*hi +
    hi*lo, then + hi*hi), added to the fp32 sum in k order; acc None starts
    from zero."""
    for k0 in range(0, a.shape[-1], 16):
        x, w = a[..., k0:k0 + 16], wt[k0:k0 + 16]
        if mode == "bf16_3x":
            (x_hi, x_lo), (w_hi, w_lo) = split(x), split(w)
            part = (x_hi @ w_lo + x_lo @ w_hi) + x_hi @ w_hi
        else:
            part = bf16(x) @ bf16(w)
        acc = part if acc is None else acc + part
    return acc


def lstm_mma_reference(
    x: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
    tier: Tier | str = FAITHFUL,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version in the bf16 tiers' kernel order (csrc/lstm_mma.cuh):
    per layer the input gate sums of all frames first (`mma_sum` of the
    layer's input against rows 0..H-1 of its transposed weight), then the
    recurrence from them (the recurrent k16 steps added on, then the bias;
    gate order i, f, g, o); the tier's tanh. At faithful,
    `lstm_hoisted_reference`. Shapes as `lstm_fused_reference`."""
    tier = tier_of(tier)
    if tier.products == "fp32":
        return lstm_hoisted_reference(x, h0, c0, w, b, tier)
    hidden = x.shape[-1]
    wt = transpose_weight(w)
    seq, hn, cn = x, [], []
    for layer in range(wt.shape[0]):
        pre = mma_sum(seq, wt[layer, :hidden], tier.products)  # [B, T, 4H]
        w_rec = wt[layer, hidden:]
        h, c = h0[layer], c0[layer]
        outs = []
        for t in range(seq.shape[1]):
            gates = mma_sum(h, w_rec, tier.products, pre[:, t]) + b[layer]
            i, f, g, o = gates.chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * tanh_at(g, tier)
            h = torch.sigmoid(o) * tanh_at(c, tier)
            outs.append(h)
        seq = torch.stack(outs, dim=1)
        hn.append(h)
        cn.append(c)
    return seq, torch.stack(hn), torch.stack(cn)


#: The resident-weights variant takes a call of at least this many steps (T of
#: `lstm_fused`, K * T of `lstm_decoder_fused`) a stream; shorter ones keep the
#: streaming-weights variant, which has no pre-pass and no weights to load.
#: Measured by `chip_smoke.py` (its "time variants" lines) on an NVIDIA H100
#: 80GB HBM3, 700.00 W, streaming / resident ms at B = 1, 64, 2048:
#:   v4 (H=64, L=2)  T=1: 0.0192 / 0.0255, 0.0220 / 0.0381, 0.0270 / 0.0408
#:                   T=3: 0.0490 / 0.0300, 0.0495 / 0.0230, 0.0714 / 0.0620
#:   v5 (H=128, L=1) T=1: 0.0221 / 0.0358, 0.0226 / 0.0457, 0.0478 / 0.0607
#:                   T=2: 0.0343 / 0.0295, 0.0351 / 0.0361, 0.0837 / 0.0943
#:                   T=3: 0.0493 / 0.0335, 0.0502 / 0.0317, 0.1226 / 0.1186
#:   `lstm_decoder_fused` K=1 x T=7: 0.1479 / 0.0249, 0.1524 / 0.0233,
#:                   0.2516 / 0.1200
#: From 3 steps on the resident variant won at every batch measured; at 1 step
#: the streaming one did, and at 2 steps the two split by batch.
RESIDENT_MIN_STEPS = 3


def use_resident(batch: int, steps: int) -> bool:
    """Which variant of the two recurrent kernels runs `steps` steps of each
    of `batch` streams: from the shapes alone (the measured crossover lies at
    the same step count at every batch). Both give the same bits, so the
    choice cannot change a result."""
    return steps >= RESIDENT_MIN_STEPS


#: most bytes of scratch the resident variant asks for (its input gate sums,
#: 16 * H bytes a frame of a stream); a longer call walks the frames in passes
PRE_BYTES_MAX = 256 << 20


def pre_scratch(x: torch.Tensor, batch: int, steps: int, unit: int) -> torch.Tensor:
    """The resident variant's scratch for `steps` frames of `batch` streams
    of x's width: all rows, or as many as PRE_BYTES_MAX holds but at least
    `unit` frames of every stream."""
    hidden = x.shape[-1]
    rows = min(batch * steps, max(batch * unit, PRE_BYTES_MAX // (16 * hidden)))
    return torch.empty((rows, 4 * hidden), dtype=torch.float32, device=x.device)


#: the most streams a block of the bf16 tiers' recurrent kernels takes (a
#: cluster at H=128): one n8 tile of the gate sums (csrc/lstm_mma.cuh)
MMA_MAX_STREAMS = 8
#: the shared memory one block may use on an H100 (and static shared memory
#: without an opt-in)
SMEM_PER_BLOCK, STATIC_SMEM = 232448, 48 * 1024


def mma_streams(batch: int, sms: int) -> int:
    """Streams a block of the bf16 tiers' kernels takes: the fewest that
    leave no more blocks than the card has SMs, 8 beyond that (a block's
    MMAs cost the same for 1 to 8 streams). A function of the shapes."""
    return max(1, min(MMA_MAX_STREAMS, -(-batch // sms)))


def mma_plan(batch: int, steps: int, hidden: int, layers: int, tier: Tier | str,
             sms: int) -> list[dict]:
    """The kernels one call of `lstm_fused` launches at a bf16 tier (the
    resident variant's first pass), as the CUDA sources size them: name,
    threads and blocks, streams a block, static and dynamic shared memory
    in bytes."""
    tier = tier_of(tier)
    if tier.products == "fp32":
        raise ValueError("mma_plan: the faithful instances keep their CUDA-core kernels")
    nb = mma_streams(batch, sms)
    split_planes = tier.products == "bf16_3x"
    f32, frag = 4, 16 * 32  # bytes of a float, of a fragment step's 32 lanes
    rows, gates = MMA_MAX_STREAMS * (hidden + 8), MMA_MAX_STREAMS * (4 * hidden + 4)  # floats
    if (hidden, layers) not in RESIDENT_SHAPES or not use_resident(batch, steps):
        return [{"kernel": "lstm_mma_kernel", "threads": 256, "blocks": -(-batch // nb),
                 "streams": nb, "static_smem": 0,
                 "dynamic_smem": f32 * (rows * (1 + 2 * layers) + gates)}]
    pre = {"kernel": "input_gates_mma_kernel", "threads": 256,
           "blocks": -(-batch * steps // 64) * (hidden // 4) // (8 * (128 // hidden)),
           "streams": None, "static_smem": f32 * 64 * (hidden + 8), "dynamic_smem": 0}
    k = hidden // 16  # k16 steps of a half
    if hidden == 64:  # h and the sums of both layers, the decoder's means
        rec = {"kernel": "wavefront_mma_kernel", "threads": 512, "blocks": -(-batch // nb),
               "streams": nb, "static_smem": f32 * (2 * rows + 2 * gates + 2 * 8 * hidden),
               "dynamic_smem": frag * 16 * 3 * k if split_planes else 0}
    else:  # h double-buffered, the sums
        rec = {"kernel": "cluster_mma_kernel", "threads": 512, "blocks": 2 * -(-batch // nb),
               "streams": nb, "static_smem": f32 * (2 * rows + gates),
               "dynamic_smem": frag * 16 * k if split_planes else 0}
    return [pre, rec]


_SMS: dict = {}


def _streams(x: torch.Tensor, tier: Tier) -> int:
    """mma_streams at x's batch on x's card (the CUDA-core kernels ignore
    it)."""
    if tier.products == "fp32":
        return 0
    if x.device not in _SMS:
        _SMS[x.device] = torch.cuda.get_device_properties(x.device).multi_processor_count
    return mma_streams(x.shape[0], _SMS[x.device])


def _launch_streaming(x, h0, c0, wt, b, y, hn, cn, tier: Tier = FAITHFUL) -> int:
    """Launches the streaming-weights kernel's instance of the tier; returns
    the kernels launched."""
    batch, seq, hidden = x.shape
    status = _build.library().vadc_lstm_fused(
        x.data_ptr(), h0.data_ptr(), c0.data_ptr(), wt.data_ptr(), b.data_ptr(),
        y.data_ptr(), hn.data_ptr(), cn.data_ptr(), batch, seq, hidden, wt.shape[0], tier.index,
        _streams(x, tier), torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(status, "lstm_fused")
    return 1


def _launch_resident(x, h0, c0, wt, b, y, hn, cn, tier: Tier = FAITHFUL) -> int:
    """Launches the resident-weights variant's instance of the tier: the
    pre-pass and the recurrent kernel, once for each pass over the scratch;
    returns the kernels launched."""
    batch, seq, hidden = x.shape
    pre = pre_scratch(x, batch, seq, 1)
    launched = ctypes.c_int(0)
    status = _build.library().vadc_lstm_fused_resident(
        x.data_ptr(), h0.data_ptr(), c0.data_ptr(), wt.data_ptr(), b.data_ptr(),
        pre.data_ptr(), pre.shape[0], y.data_ptr(), hn.data_ptr(), cn.data_ptr(), batch, seq,
        hidden, wt.shape[0], tier.index, _streams(x, tier), ctypes.byref(launched),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(status, "lstm_fused (resident)")
    return launched.value


def lstm_fused(
    x: torch.Tensor,
    h0: torch.Tensor,
    c0: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    *,
    hn: torch.Tensor | None = None,
    cn: torch.Tensor | None = None,
    wt: torch.Tensor | None = None,
    tier: Tier | str = FAITHFUL,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [B, T, H]; h0, c0 [L, B, H]; w [L, 4H, 2H]; b [L, 4H] -> (y [B, T,
    H], hn, cn), the top layer's h at every step and the final state, the
    gates' products and tanh at the tier.

    The new state goes to `hn`/`cn` when given, which may BE `h0`/`c0` (the
    state is then updated in place); otherwise to new tensors. `wt` is
    `kernel_weight(w, tier)` when the caller keeps it (models pass the one
    cached on their Params: `weight_of(params, tier)`). A CPU tensor takes
    the plain version; a CUDA tensor launches the tier's instance of the
    kernel (the variant `use_resident` names) or raises."""
    tier = tier_of(tier)
    if x.device.type == "cpu":
        y, h_new, c_new = lstm_fused_reference(x, h0, c0, w, b, tier)
        if hn is not None:
            h_new = hn.copy_(h_new)
        if cn is not None:
            c_new = cn.copy_(c_new)
        return y, h_new, c_new
    if wt is None:
        wt = kernel_weight(w, tier)
    if hn is None:
        hn = torch.empty_like(h0)
    if cn is None:
        cn = torch.empty_like(c0)
    _check(x, h0, c0, wt, b, hn, cn, tier)
    y = torch.empty_like(x)
    resident = (x.shape[2], wt.shape[0]) in RESIDENT_SHAPES and use_resident(*x.shape[:2])
    launch = _launch_resident if resident else _launch_streaming
    lstm_fused.launches += launch(x, h0, c0, wt, b, y, hn, cn, tier)
    return y, hn, cn


#: kernels launched since the count was last set to 0: one a call of the
#: streaming variant, two a pass of the resident one (its pre-pass counts)
lstm_fused.launches = 0


def _check(x, h0, c0, wt, b, hn, cn, tier) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"lstm_fused: unsupported device {x.device}")
    if x.dim() != 3 or x.shape[2] not in HIDDEN_SIZES or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(
            f"lstm_fused: x must be [B, T, H] with H in {HIDDEN_SIZES}, got {tuple(x.shape)}"
        )
    batch, _, hidden = x.shape
    layers = wt.shape[0]
    state_shape = (layers, batch, hidden)
    shapes = {"wt": weight_shape(layers, hidden, tier), "b": (layers, 4 * hidden),
              "h0": state_shape, "c0": state_shape, "hn": state_shape, "cn": state_shape}
    for name, t in (("x", x), ("h0", h0), ("c0", c0), ("wt", wt), ("b", b), ("hn", hn),
                    ("cn", cn)):
        if t.dtype != torch.float32:
            raise TypeError(f"lstm_fused: {name} must be float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"lstm_fused: {name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"lstm_fused: {name} must be contiguous")
        if name in shapes and tuple(t.shape) != shapes[name]:
            raise ValueError(f"lstm_fused: {name} {tuple(t.shape)} is not {shapes[name]}")
    # the tier's instance reads wt as packed for its products; a weight
    # packed for another mode would compute another function without a fault
    mode = getattr(wt, "_vadc_products", None)
    if mode != tier.products:
        raise ValueError(
            f"lstm_fused: the {tier} instance takes wt packed for {tier.products} products "
            f"(kernel_weight(w, {tier.name!r})), got one packed for {mode}"
        )
