"""The volume march kernel's tables (kernels/volume.py volume_pack,
pad_texels, brick_table, pack_bits) on the CPU, on grids of 13 x 20 x 37
texels (not multiples of a brick), all made from seeded numpy inputs:

- the padded copy's trilinear fetch as the kernel takes it (the base cell
  clamped once per axis into [-1, n - 1], 8 corners at fixed offsets) is
  the port's ``_tex3d_multi`` bit for bit, and JAX's ``_tex3d_multi``
  within 1e-6 (XLA contracts some products into FMAs), at unit-cube
  positions in and out of [0, 1];
- the brick table's window reductions equal a loop over the bricks, NaN
  included, and the table is conservative: a plain re-march
  (tests/volume_steps.py) finds no step that the kernel would skip whose
  opacity is not exactly 0 or whose colour is not finite, on random
  volumes and transfers with zero-alpha ranges, negative alpha, NaN and
  infinite texels, infinite RGB, texels of +-1e3 against 1,024 entries,
  and boxes whose dt is 0, negative or set by a large step scale; the
  march with the skipped steps left out equals ``march_plain`` bit for
  bit;
- the pack is kept while the texels and the transfer are the same
  tensors, unwritten, and rebuilt after an in-place write to either, for
  another transfer tensor or another brick size.

The kernel that reads these tables runs only on the card
(tests/test_torch_cuda_volume.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from visionaray_tpu.kernels import volume as jvol

from visionaray_torch.kernels import volume as tvol

from volume_steps import march_steps

torch.set_num_threads(1)
DHW = (13, 20, 37)
BG = torch.tensor((0.1, 0.4, 1.0, 1.0))


def padded_fetch(padded, vi, u, v, w, dims):
    """The kernel's trilinear fetch (volume_common.cuh fast_step) from the
    padded copy, in _tex3d_multi's weights and order."""
    D, H, W = dims
    x = u * W - 0.5
    y = v * H - 0.5
    z = w * D - 0.5
    x0 = torch.floor(x).to(torch.int32)
    y0 = torch.floor(y).to(torch.int32)
    z0 = torch.floor(z).to(torch.int32)
    fx, fy, fz = x - x0, y - y0, z - z0
    xb = torch.clamp(x0, -1, W - 1).long() + 1
    yb = torch.clamp(y0, -1, H - 1).long() + 1
    zb = torch.clamp(z0, -1, D - 1).long() + 1
    vl = vi.long()
    out = 0.0
    for dz in (0, 1):
        wz = (1 - fz) if dz == 0 else fz
        for dy in (0, 1):
            wy = (1 - fy) if dy == 0 else fy
            for dx in (0, 1):
                wx = (1 - fx) if dx == 0 else fx
                out = out + wz * wy * wx * padded[vl, zb + dz, yb + dy,
                                                  xb + dx]
    return out


def _field(rng, V=1, dims=DHW, coarse=4):
    """Smooth random fields in [0, 1]: a coarse grid upsampled, so that
    bricks differ (some all low, some high)."""
    g = torch.as_tensor(rng.uniform(0.0, 1.0, (V, 1) + (coarse,) * 3)
                        .astype(np.float32) ** 3)
    return torch.nn.functional.interpolate(
        g, size=dims, mode="trilinear", align_corners=True)[:, 0].contiguous()


def _transfer(rng, V=1, T=32, gate=0.3, alpha_lo=0.0):
    """Ramps whose alpha is alpha_lo (0 or negative) below ``gate``."""
    t = np.linspace(0.0, 1.0, T, dtype=np.float32)
    tabs = []
    for _ in range(V):
        rgb = rng.uniform(0.0, 1.0, (T, 3)).astype(np.float32)
        a = np.where(t < gate, alpha_lo, rng.uniform(0.05, 0.9, T))
        tabs.append(np.concatenate([rgb, a[:, None].astype(np.float32)], -1))
    return torch.as_tensor(np.stack(tabs))


def _rays(rng, lo, hi, n=192):
    """Rays from around the boxes' union towards points inside it."""
    lo, hi = torch.minimum(lo, hi).min(0).values.numpy(), \
        torch.maximum(lo, hi).max(0).values.numpy()
    c = (lo + hi) / 2
    r = float(np.linalg.norm(hi - lo))
    dirs = rng.normal(size=(n, 3))
    o = c + r * dirs / np.linalg.norm(dirs, axis=1, keepdims=True)
    target = rng.uniform(lo, hi, (n, 3))
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.as_tensor(o.astype(np.float32)),
            torch.as_tensor(d.astype(np.float32)))


def test_padded_fetch_equals_tex3d():
    rng = np.random.default_rng(11)
    texels = torch.as_tensor(rng.uniform(-1.0, 2.0, (2,) + DHW)
                             .astype(np.float32))
    padded = tvol.pad_texels(texels)
    assert padded.shape == (2, DHW[0] + 2, DHW[1] + 2, DHW[2] + 2)
    n = 4096
    uvw = torch.as_tensor(rng.uniform(-0.6, 1.6, (n, 3)).astype(np.float32))
    # cells at x0 = -1 and x0 = n - 1 exactly: u = 0 and u = 1
    uvw[:64, 0] = 0.0
    uvw[64:128, 1] = 1.0
    uvw[128:192, 2] = 0.0
    vi = torch.as_tensor(rng.integers(0, 2, n).astype(np.int32))
    u, v, w = uvw.unbind(-1)
    got = padded_fetch(padded, vi, u, v, w, DHW)
    ref = tvol._tex3d_multi(texels, vi, u, v, w)
    assert torch.equal(got, ref)
    jref = np.asarray(jvol._tex3d_multi(jnp.asarray(texels.numpy()),
                                        jnp.asarray(vi.numpy()),
                                        jnp.asarray(u.numpy()),
                                        jnp.asarray(v.numpy()),
                                        jnp.asarray(w.numpy())))
    np.testing.assert_allclose(got.numpy(), jref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("brick", [4, 8, 16])
def test_brick_minmax_equals_loop(brick):
    rng = np.random.default_rng(brick)
    x = torch.as_tensor(rng.normal(size=(2,) + DHW).astype(np.float32))
    x[0, 3, 5, 7] = float("nan")
    x[1, 12, 19, 36] = float("inf")
    lo, hi = tvol.brick_minmax(tvol.pad_texels(x), brick)
    nb = [-(-s // brick) for s in DHW]
    assert tuple(lo.shape) == (2, *nb)
    for v in range(2):
        for bz in range(nb[0]):
            for by in range(nb[1]):
                for bx in range(nb[2]):
                    win = x[v, brick * bz:brick * bz + brick + 1,
                            brick * by:brick * by + brick + 1,
                            brick * bx:brick * bx + brick + 1]
                    for got, fn in ((lo, torch.amin), (hi, torch.amax)):
                        want = fn(win) if not torch.isnan(win).any() \
                            else torch.tensor(float("nan"))
                        g = got[v, bz, by, bx]
                        assert torch.equal(torch.isnan(g), torch.isnan(want))
                        if not torch.isnan(want):
                            assert g == want


def test_pack_bits_round_trip():
    rng = np.random.default_rng(3)
    table = torch.as_tensor(rng.uniform(size=(3, 5, 6, 7)) < 0.5)
    words = tvol.pack_bits(table)
    assert words.dtype == torch.int32
    assert words.numel() == -(-table.numel() // 32)
    w = words.to(torch.int64) & 0xFFFFFFFF
    bits = (w[:, None] >> torch.arange(32)) & 1
    assert torch.equal(bits.reshape(-1)[:table.numel()].bool(),
                       table.reshape(-1))
    assert not bits.reshape(-1)[table.numel():].any()


def _case(name, rng):
    """(volumes, step_scale) of one conservativeness case."""
    lo = torch.tensor([[-1.0, -0.8, -1.2]])
    hi = torch.tensor([[1.0, 0.9, 1.1]])
    texels = _field(rng)
    transfer = _transfer(rng)
    step_scale = 1.0
    if name == "negative_alpha":
        transfer = _transfer(rng, gate=0.4, alpha_lo=-0.3)
    elif name == "nonfinite_texels":
        flat = texels.reshape(-1)
        idx = torch.as_tensor(rng.choice(flat.numel(), 40, replace=False))
        flat[idx[:20]] = float("nan")
        flat[idx[20:30]] = float("inf")
        flat[idx[30:]] = -float("inf")
    elif name == "inf_rgb":
        transfer[0, 1, 0] = float("inf")
        transfer[0, 3, 2] = -float("inf")
        transfer[0, 5, 1] = float("nan")
    elif name == "large_texels":
        # samples of +-1e3 against 1,024 entries (M T ~ 1e6): those below
        # 0 clamp to entry 0, the one of alpha 0
        texels = (texels - 0.3) * 1e3
        transfer = _transfer(rng, T=1024, gate=0.0)
        transfer[0, 0, 3] = 0.0
    elif name == "three_overlapping":
        lo = torch.tensor([[-1.0, -1.0, -1.0], [-0.3, -0.6, -0.5],
                           [0.2, -1.1, -0.2]])
        hi = torch.tensor([[1.0, 1.0, 1.0], [1.3, 0.6, 0.7],
                           [1.6, 0.5, 1.4]])
        texels = _field(rng, V=3)
        transfer = _transfer(rng, V=3)
    elif name == "dt_zero":
        hi = torch.tensor([[1.0, -0.8, 1.1]])   # no extent along y
    elif name == "dt_negative":
        lo, hi = hi.clone(), lo.clone()          # an inverted box
    elif name == "dt_large":
        step_scale = 1e30
    vols = tvol.Volumes(lo=lo, hi=hi, texels=texels.contiguous(),
                        transfer=transfer.contiguous())
    return vols, step_scale


CASES = ["zero_alpha", "negative_alpha", "nonfinite_texels", "inf_rgb",
         "large_texels", "three_overlapping", "dt_zero", "dt_negative",
         "dt_large"]


def _equal(a, b):
    return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(
        torch.nan_to_num(a, nan=0.0), torch.nan_to_num(b, nan=0.0))


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("brick", [4, 8])
def test_brick_table_is_conservative(name, brick):
    rng = np.random.default_rng(CASES.index(name) * 10 + brick)
    vols, step_scale = _case(name, rng)
    o, d = _rays(rng, vols.lo, vols.hi)
    plain = tvol.march_plain(o, d, vols, BG, step_scale)
    run = march_steps(o, d, vols, BG, step_scale, brick=brick, skip=True)
    assert run["changed"] == 0
    assert _equal(run["color"], plain[0])
    assert torch.equal(run["hit"], plain[1])
    assert _equal(run["depth"], plain[2])
    if name in ("zero_alpha", "negative_alpha", "three_overlapping",
                "large_texels"):
        # the skip has steps to take, and leaves some
        assert 0 < int(run["empty"].sum()) < int(run["steps"].sum())
    if name in ("dt_negative", "dt_large"):
        assert int(run["steps"].sum()) > 0


def test_table_marks_what_it_must():
    """All alpha 0: every brick empty; all alpha > 0: none; NaN texels
    and an infinite RGB entry in a brick's range make it not empty."""
    rng = np.random.default_rng(21)
    texels = _field(rng)
    tr = _transfer(rng, gate=0.0)
    assert not tvol.brick_table(texels, tr, 8).any()
    tr[..., 3] = 0.0
    assert tvol.brick_table(texels, tr, 8).all()
    tex = texels.clone()
    tex[0, 0, 0, 0] = float("nan")
    table = tvol.brick_table(tex, tr, 8)
    assert not table[0, 0, 0, 0] and table.sum() == table.numel() - 1
    tr[0, 0, 0] = float("inf")
    low = torch.zeros_like(texels)   # samples only entries 0 and 1
    assert not tvol.brick_table(low, tr, 8).any()
    tr[0, 0, 0] = 0.5
    tr[0, 0, 3] = -1.0               # negative alpha is empty too
    assert tvol.brick_table(low, tr, 8).all()


def _vols(rng):
    return tvol.Volumes(lo=torch.tensor([[-1.0, -1.0, -1.0]]),
                        hi=torch.tensor([[1.0, 1.0, 1.0]]),
                        texels=_field(rng), transfer=_transfer(rng))


def test_pack_kept_while_unchanged():
    vols = _vols(np.random.default_rng(5))
    pack = tvol.volume_pack(vols)
    assert tvol.volume_pack(vols) is pack
    same = tvol.Volumes(lo=vols.lo * 2, hi=vols.hi * 2, texels=vols.texels,
                        transfer=vols.transfer)
    assert tvol.volume_pack(same) is pack
    assert pack.brick == tvol.BRICK
    assert torch.equal(pack.padded, tvol.pad_texels(vols.texels))
    assert torch.equal(pack.table, tvol.brick_table(vols.texels,
                                                    vols.transfer))
    assert torch.equal(pack.bits, tvol.pack_bits(pack.table))


@pytest.mark.parametrize("change", ["texels", "transfer", "new_transfer",
                                    "brick"])
def test_pack_rebuilt_after_a_change(change, monkeypatch):
    vols = _vols(np.random.default_rng(6))
    pack = tvol.volume_pack(vols)
    if change == "texels":
        with torch.no_grad():
            vols.texels.mul_(0.0)
    elif change == "transfer":
        with torch.no_grad():
            vols.transfer[..., 3] = 0.0
    elif change == "new_transfer":
        vols = tvol.Volumes(lo=vols.lo, hi=vols.hi, texels=vols.texels,
                            transfer=vols.transfer.clone() * 0.0)
    else:
        monkeypatch.setattr(tvol, "BRICK", 2 * tvol.BRICK)
    again = tvol.volume_pack(vols)
    assert again is not pack
    assert torch.equal(again.padded, tvol.pad_texels(vols.texels))
    assert torch.equal(again.table, tvol.brick_table(
        vols.texels, vols.transfer, again.brick))
    if change in ("texels", "transfer", "new_transfer"):
        assert again.table.all() and not pack.table.all()


def test_pack_refusals_and_forms(monkeypatch):
    vols = _vols(np.random.default_rng(7))
    monkeypatch.setattr(tvol, "BRICK", 6)
    with pytest.raises(ValueError, match="power of 2"):
        tvol.volume_pack(vols)
    assert tvol.transfer_form(1, 64) == "shared"
    assert tvol.transfer_form(3, 1024) == "shared"
    assert tvol.transfer_form(1, 4096) == "global"
    assert tvol.transfer_form(4, 1024) == "global"
