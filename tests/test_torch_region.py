"""The index arithmetic of K3's bf16 conv (``csrc/s2d_region.cu``), emulated
in plain torch on the CPU.

``pack_weights`` lays conv_1's kernel out as wgmma's B operand; the tests
unpack it. The emulation follows the kernel step by step: it builds each
segment's halo tile of the activated input in the stage layout
``[channel group of 8][halo row][halo column][8]`` (group planes padded as
the kernel pads them), takes tap (ky, kx)'s A operand as the view of that
flat stage at the shifted start address with the descriptor's strides,
multiplies it by the packed weights, and stores each accumulator row q-major
and into its consumer warp's row of IN2 partials. In float32 it must match
``conv_s2d`` of the activated input to rtol 1e-5 (atol 1e-5: the sums run in
another order), and the partial rows must add up to the conv's own sums.
"""

import numpy as np
import pytest
import torch

from unet_implementations_tpu_torch.kernels import s2d_region
from unet_implementations_tpu_torch.ops.s2d import conv_s2d

# The bf16 kernel's geometry (kRows, kSegW, kPartialRows, kCoreBytes in the
# source): a band of 4 rows walked in 64-column segments, halo 6 x 66.
ROWS, SEG_W, PARTIAL_ROWS, CORE_BYTES = 4, 64, 4, 128
HALO_ROWS, HALO_COLS = ROWS + 2, SEG_W + 2


def _plane_elems(groups: int) -> int:
    """Cfg::kPlane in bf16 elements: a group plane rounded up to 128 bytes,
    plus 128 / groups bytes."""
    nbytes = -(-HALO_ROWS * HALO_COLS * 16 // 128) * 128 + CORE_BYTES // groups
    return nbytes // 2


def _case(shape, seed=0):
    rng = np.random.default_rng(seed)
    c = shape[-1] // 4

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    return (t(rng.normal(size=shape) * 2 + 0.5), t(rng.uniform(0.5, 1.5, c)),
            t(rng.normal(size=c) * 0.1), t(rng.normal(size=(c, c, 3, 3)) * np.sqrt(2 / (9 * c))))


def _unpack(packed: torch.Tensor, c: int) -> torch.Tensor:
    """(9, CP/16, 2, CP/8, 8, 8) -> (C, C, 3, 3)."""
    cp = packed.shape[3] * 8
    # [tap, kc, k8, n8, nr, kr] -> [n8, nr, kc, k8, kr, tap] = [co, ci, tap]
    w = packed.permute(3, 4, 1, 2, 5, 0).reshape(cp, cp, 3, 3)
    assert not w[c:].any() and not w[:, c:].any()
    return w[:c, :c]


def _emulate(act: torch.Tensor, packed: torch.Tensor):
    """The bf16 kernel's conv and IN2 partials, computed in float32 with its
    index arithmetic. ``act``: the activated input (B, H', W', 4C) q-major."""
    b_n, hp, wp, c4 = act.shape
    c = c4 // 4
    cp = packed.shape[3] * 8
    groups, ksteps = cp // 8, cp // 16
    hf, wf = 2 * hp, 2 * wp
    plane = _plane_elems(groups)
    # The full-resolution image, channels padded to CP, with a zero border.
    dense = act.reshape(b_n, hp, wp, 2, 2, c).permute(0, 1, 3, 2, 4, 5).reshape(b_n, hf, wf, c)
    nbands, nseg = -(-hf // ROWS), -(-wf // SEG_W)
    padded = torch.zeros(b_n, nbands * ROWS + 2, nseg * SEG_W + 2, cp)
    padded[:, 1:hf + 1, 1:wf + 1, :c] = dense
    out = torch.zeros_like(act)
    partials = torch.zeros(b_n, nbands * PARTIAL_ROWS, 2, c4)
    for b in range(b_n):
        for band in range(nbands):
            y0 = band * ROWS
            for seg in range(nseg):
                x0 = seg * SEG_W
                tile = padded[b, y0:y0 + HALO_ROWS, x0:x0 + HALO_COLS]  # halo row, col, ch
                stage = torch.zeros(groups * plane)
                for g in range(groups):
                    stage[g * plane:g * plane + HALO_ROWS * HALO_COLS * 8] = (
                        tile[..., 8 * g:8 * g + 8].reshape(-1))
                for rr in range(ROWS):
                    acc = torch.zeros(SEG_W, cp)
                    for tap in range(9):
                        ky, kx = divmod(tap, 3)
                        for kc in range(ksteps):
                            # Descriptor: start, leading byte offset (K) one
                            # plane, stride byte offset (M) 128 bytes = 8
                            # pixels, a core matrix row 16 bytes = 1 pixel.
                            start = 2 * kc * plane + ((rr + ky) * HALO_COLS + kx) * 8
                            a = torch.as_strided(stage, (SEG_W, 2, 8), (8, plane, 1),
                                                 start).reshape(SEG_W, 16)
                            bmat = packed[tap, kc].permute(0, 3, 1, 2).reshape(16, cp)
                            acc += a @ bmat
                    yy = y0 + rr
                    for m in range(SEG_W):
                        xx = x0 + m
                        if yy >= hf or xx >= wf:
                            continue
                        q = (yy % 2) * 2 + xx % 2
                        v = acc[m, :c]
                        out[b, yy // 2, xx // 2, q * c:(q + 1) * c] = v
                        row = band * PARTIAL_ROWS + m // 16  # the consumer warp
                        partials[b, row, 0, q * c:(q + 1) * c] += v
                        partials[b, row, 1, q * c:(q + 1) * c] += v * v
    return out, partials


@pytest.mark.parametrize("c", [8, 16, 32, 64])
def test_pack_weights_unpacks_to_the_kernel(c):
    w = _case((1, 2, 2, 4 * c), seed=c)[3]
    packed = s2d_region.pack_weights(w)
    cp = max(c, 16)
    assert packed.shape == (9, cp // 16, 2, cp // 8, 8, 8) and packed.is_contiguous()
    assert torch.equal(_unpack(packed, c), w)
    assert packed.numel() * 2 == 9 * cp * cp * 2  # the bytes of the bulk copy, in bf16


@pytest.mark.parametrize("shape", [(24, 24, 3, 3), (16, 8, 3, 3), (16, 16, 1, 1)])
def test_pack_weights_refuses_what_the_kernel_does_not_take(shape):
    with pytest.raises(ValueError, match="pack_weights takes"):
        s2d_region.pack_weights(torch.zeros(shape))


@pytest.mark.parametrize("shape", [(2, 8, 8, 32), (1, 9, 13, 64), (1, 16, 40, 128),
                                   (1, 8, 8, 256)])
def test_emulated_kernel_matches_conv_s2d(shape):
    """16x16 to 32x80 full-resolution pixels: C = 8 padded to 16, a band past
    the last row, a segment past the last column, C = 32 and 64."""
    x, scale1, bias1, weight = _case(shape)
    act = s2d_region.activated_input(x, scale1, bias1, 1e-5, 0.01)
    got, partials = _emulate(act, s2d_region.pack_weights(weight))
    want = conv_s2d(act, weight, None)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert partials.shape[1] == s2d_region._partial_rows(torch.bfloat16, shape[1])
    sums = torch.stack([want.sum(dim=(1, 2)), (want * want).sum(dim=(1, 2))], dim=1)
    torch.testing.assert_close(partials.sum(dim=1), sums, rtol=1e-5, atol=1e-4)


def test_kernel_weights_layouts():
    """bf16: the packed B operand; float32: (3, 3, C_in, C_out)."""
    w = _case((1, 2, 2, 32))[3]
    assert torch.equal(s2d_region.kernel_weights(w, torch.bfloat16),
                       s2d_region.pack_weights(w.to(torch.bfloat16)))
    f32 = s2d_region.kernel_weights(w, torch.float32)
    assert torch.equal(f32, w.permute(2, 3, 1, 0)) and f32.is_contiguous()
