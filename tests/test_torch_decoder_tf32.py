"""K1's arithmetic on the CPU: the packed weights of
`kernels/decoder_fused.pack_params` and the 3xTF32 products of
csrc/decoder_fused.cu, emulated in torch, against the JAX package.

The kernel itself needs the card (tests/test_torch_kernels_cuda.py). What
can be checked here is everything it reads and how it combines it:

* the hi parts of the packed weights are TF32 values (low 13 mantissa bits
  zero), and hi + lo gives back each weight within 2^-22 relative (hi is
  within half a TF32 ulp, 2^-11 relative, and lo is rounded to TF32 again);
* the packed size equals a mirror of the kernel's layout constants
  (pass_k8, pass_n, pass_stage_n, O_BIAS..P_TOTAL);
* the products, taken out of the packed buffer in the kernel's stage order
  and computed as a_hi b_hi + a_hi b_lo + a_lo b_hi in f32, with the
  kernel's padding (layer 3 to 512 outputs, x in columns 445..511 for
  layer 4, the re-injection term parked and added at the end), meet K1's
  tolerances against `fused_sdf_and_input_grad(..., interpret=True)`:
  sdf within 1e-5; gradient 99th-percentile error < 1e-4 with at most
  max(3, N/1000) rows above 1e-4 (a point on a ReLU boundary may take the
  other subgradient);
* the tensor cores add each k8 product into their f32 accumulator with
  truncation to 24 bits. Emulated so, 192 such adds per 512-deep product
  miss the sdf tolerance; flushing the accumulator into a rounded f32 total
  every CHUNK = 4 k8 blocks, as the kernel does, meets it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dspslam_tpu.ops.pallas import decoder_kernel as jdk
from dspslam_tpu_torch.kernels import decoder_fused
from dspslam_tpu_torch.models import deepsdf

HID, IN, NARROW = 512, 67, 445


def kernel_layout():
    """(layer, forward, N, K) of the kernel's 16 passes and the packed
    total, written from csrc/decoder_fused.cu's constants: pass p < 8 is
    forward layer p, p >= 8 backward layer 15 - p; k8 blocks 72 / 8 for
    p == 0, 448 / 8 for backward layer 3, else 512 / 8; N 72 for p == 15,
    else 512; then b0..b7 (8 x 512), w8 (512), b8 (4)."""
    out = []
    for p in range(16):
        layer = p if p < 8 else 15 - p
        k8 = 72 // 8 if p == 0 else 448 // 8 if p >= 8 and layer == 3 else 512 // 8
        n = 72 if p == 15 else 512
        out.append((layer, p < 8, n, 8 * k8))
    total = sum(16 * n * k // 8 for _, _, n, k in out) + 8 * 512 + 512 + 4
    return out, total


@pytest.fixture(scope="module")
def canonical():
    rng = np.random.default_rng(0)
    dims = deepsdf.DecoderConfig().layer_dims()
    params_np = {
        "w": [(rng.normal(size=(i, o)) * np.sqrt(2.0 / i)).astype(np.float32) for i, o in dims],
        "b": [(rng.normal(size=(o,)) * 0.05).astype(np.float32) for _, o in dims],
    }
    dec = deepsdf.params_from_jax(params_np)
    packed = decoder_fused.pack_params(list(dec.weights), list(dec.biases))
    return params_np, dec, packed


def unpack(packed):
    """Per pass, the (N, K) hi and lo matrices read back in stage order
    ([column half][k8 block][hi, lo][n / 8 groups][2 k-halves][8 rows][4 k],
    halves of 256 columns, the 72-column pass in one), and the vectors."""
    layout, _ = kernel_layout()
    mats, off = [], 0
    for layer, forward, n, k in layout:
        w = min(n, 256)
        block = packed[off: off + 2 * n * k].reshape(n // w, k // 8, 2, w // 8, 2, 8, 4)
        hi, lo = (block[:, :, part].permute(0, 2, 4, 1, 3, 5).reshape(n, k) for part in (0, 1))
        mats.append((layer, forward, hi, lo))
        off += 2 * n * k
    biases = packed[off: off + 8 * HID].reshape(8, HID)
    w8 = packed[off + 8 * HID: off + 9 * HID]
    b8 = packed[off + 9 * HID]
    return mats, biases, w8, b8


def expected_matrix(dec, layer, forward, n, k):
    w = dec.weights[layer].detach()
    m = w if forward else w.t()
    return torch.nn.functional.pad(m, (0, k - m.shape[1], 0, n - m.shape[0]))


def test_packed_size_matches_the_kernel_layout(canonical):
    _, _, packed = canonical
    layout, total = kernel_layout()
    assert [(l, f, n, k) for l, f, n, k in decoder_fused.passes()] == layout
    assert packed.numel() == total == decoder_fused.packed_floats() == 7_426_564


def test_hi_parts_are_tf32_and_hi_plus_lo_gives_the_weights(canonical):
    _, dec, packed = canonical
    mats, biases, w8, b8 = unpack(packed)
    for layer, forward, hi, lo in mats:
        assert int((hi.view(torch.int32) & 0x1FFF).abs().sum()) == 0, (layer, forward)
        assert int((lo.view(torch.int32) & 0x1FFF).abs().sum()) == 0, (layer, forward)
        w = expected_matrix(dec, layer, forward, *hi.shape)
        err = (hi.double() + lo.double() - w.double()).abs()
        assert bool((err <= 2.0**-22 * w.double().abs()).all()), (layer, forward)
        assert bool((hi - w).abs().max() > 0)   # the lo parts are needed
    for layer in range(8):
        b = dec.biases[layer].detach()
        assert torch.equal(biases[layer, : b.numel()], b)
        assert not biases[layer, b.numel():].any()
    assert torch.equal(w8, dec.weights[8].detach().reshape(-1))
    assert float(b8) == float(dec.biases[8])


def mm3(a, hi, lo):
    """a @ (hi + lo)^T as the kernel's three TF32 products, f32 sums."""
    a_hi = decoder_fused.tf32_round(a)
    a_lo = decoder_fused.tf32_round(a - a_hi)
    return a_hi @ hi.t() + a_hi @ lo.t() + a_lo @ hi.t()


def mm1(a, hi, lo):
    """a @ (hi + lo)^T as one TF32 product (plain TF32)."""
    return decoder_fused.tf32_round(a) @ hi.t()


def truncating(chunk):
    """mm3 as the tensor cores add: each k8 block's three products are
    added into the accumulator one at a time, the sum truncated to 24
    significant bits; every `chunk` blocks (0: never) the accumulator is
    added into an f32 total and restarted."""

    def trunc24(v):
        m, e = torch.frexp(v)
        return torch.ldexp(torch.trunc(m * 2.0**24) / 2.0**24, e)

    def mm(a, hi, lo):
        a_hi = decoder_fused.tf32_round(a)
        a_lo = decoder_fused.tf32_round(a - a_hi)
        a_hi, a_lo, hi, lo = (t.double() for t in (a_hi, a_lo, hi, lo))
        acc = torch.zeros((a.shape[0], hi.shape[0]), dtype=torch.float64)
        total = torch.zeros((a.shape[0], hi.shape[0]))
        for kb in range(hi.shape[1] // 8):
            k = slice(8 * kb, 8 * kb + 8)
            for p, q in ((a_hi, hi), (a_hi, lo), (a_lo, hi)):
                acc = trunc24(acc + p[:, k] @ q[:, k].t())
            if chunk and (kb + 1) % chunk == 0:
                total, acc = total + acc.float(), torch.zeros_like(acc)
        return total + acc.float()

    return mm


def emulate(packed, x, mm=mm3, forward_only=False):
    """The kernel's dataflow on the CPU, operands from the packed buffer."""
    mats, biases, w8, b8 = unpack(packed)
    rows = x.shape[0]
    act = torch.zeros((rows, HID))
    act[:, :IN] = x
    masks = []
    for layer, _, hi, lo in mats[:8]:
        z = mm(act[:, : hi.shape[1]], hi, lo) + biases[layer]
        masks.append(z > 0)
        act = torch.relu(z)
        if layer == 3:
            act[:, NARROW:] = x
    y = torch.tanh(act @ w8 + b8)
    if forward_only:
        return y, None
    g = (1.0 - y * y)[:, None] * w8 * (act > 0)
    parked = None
    for layer, _, hi, lo in mats[8:15]:
        full = mm(g[:, : hi.shape[1]], hi, lo)
        if layer == 4:
            parked = full[:, NARROW:]
        g = full * masks[layer - 1]
    _, _, hi, lo = mats[15]
    return y, mm(g, hi, lo)[:, :IN] + parked


def test_3xtf32_emulation_meets_k1_tolerances_against_pallas_interpret(canonical):
    params_np, dec, packed = canonical
    x = (np.random.default_rng(64).normal(size=(64, IN)) * 0.3).astype(np.float32)
    params_j = {k: [jnp.asarray(a) for a in v] for k, v in params_np.items()}
    sdf_ref, grad_ref = jdk.fused_sdf_and_input_grad(params_j, jnp.asarray(x), True)
    sdf, grad = emulate(packed, torch.from_numpy(x))
    assert np.abs(sdf.numpy() - np.asarray(sdf_ref)).max() <= 1e-5
    err = np.abs(grad.numpy() - np.asarray(grad_ref)).max(axis=1)
    assert np.quantile(err, 0.99) < 1e-4
    assert (err > 1e-4).sum() <= max(3, len(err) // 1000)
    # plain TF32 (one product per pair) misses the tolerances: the check
    # above is not vacuous
    sdf1, grad1 = emulate(packed, torch.from_numpy(x), mm1)
    err1 = np.abs(grad1.numpy() - np.asarray(grad_ref)).max(axis=1)
    assert np.abs(sdf1.numpy() - np.asarray(sdf_ref)).max() > 1e-5 or np.quantile(err1, 0.99) >= 1e-4


def test_truncating_accumulator_needs_the_chunked_flush(canonical):
    params_np, _, packed = canonical
    x = (np.random.default_rng(64).normal(size=(64, IN)) * 0.3).astype(np.float32)
    params_j = {k: [jnp.asarray(a) for a in v] for k, v in params_np.items()}
    sdf_ref, _ = jdk.fused_sdf_and_input_grad(params_j, jnp.asarray(x), True)
    errs = {}
    for chunk in (0, 4):
        sdf, _ = emulate(packed, torch.from_numpy(x), truncating(chunk), forward_only=True)
        errs[chunk] = np.abs(sdf.numpy() - np.asarray(sdf_ref)).max()
    assert errs[0] > 1e-5 >= errs[4], errs


@pytest.mark.parametrize("n, expected", [(1, 2), (2048, 2), (4224, 2), (4225, 1), (8192, 1)])
def test_default_cluster_width_is_the_widest_that_fits_one_wave(monkeypatch, n, expected):
    """The default CTAs per 64-row tile, against a card that runs 66
    clusters of 2 at once (the occupancy query is the library's; here it
    is given)."""
    fit = {2: 66}
    monkeypatch.setattr(decoder_fused, "clusters", lambda device, cw: fit[cw])
    assert decoder_fused.width(torch.device("cuda", 0), n) == expected
