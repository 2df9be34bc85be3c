"""Fused passes over the m x n data: Pallas kernels for the GPU (Triton
route) beside the plain ``jax.numpy`` forms that XLA compiles anywhere.

  * ``kl_w_update`` / ``kl_h_update``: one KL-MUR half-update each
    (reference nmf/mur.py:20-49) in ONE read of X;
  * ``kl_obj``: the masked KL objective (nmf/utils.py:21-26);
  * ``eu_residual_obj``: 0.5 * ||X - WH||_F^2;
  * ``kl_ratio`` / ``kl_ratio_and_obj``: the ratio X / (WH + eps) that
    the XLA KL step carries between passes (no kernel: once the fused
    half-updates run, nothing on the kernel path needs the ratio).

Kernel design (FlashAttention-style, not a block-by-block GEMM).  The
W pass gives each program a ``bm``-row block of W and loops over column
tiles of X in a ``fori_loop``: ``S = W_i @ H_j``, ``R = X_ij / (S + eps)``,
``acc += R @ H_j^T``.  The H pass is the transposed form (a
``bn``-column block per program, looping over row tiles).  The
objective kernels are the W pass's loop with a reduction in place of
the second product.  Hopper blocks run in parallel, so nothing is
carried across programs: the loop axis is split over a second grid
axis, each program writes its partial numerator (or objective sum), and
XLA adds the partials and applies the k-sized closed-form update.
Neither S nor R ever reaches device memory: each pass moves X once plus
the factors.

Ragged edges are masked loads (m, n need not be multiples of a tile);
the rank is zero-padded to a power of two >= 16 (Triton's dot minimum),
which leaves every product unchanged.  X may be float32 or bfloat16 —
it is widened in registers; the factors and every sum stay float32.

Precision: the X-sized products run at the caller's matmul precision.
By default that is TF32 on the H100 (about 1e-3 relative per product,
the same as XLA's own f32 GEMMs there); under
``jax.default_matmul_precision("highest")`` they are IEEE float32.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

_EPS = 1e-9
# The kernels run only up to this padded rank.  Their products run on
# Triton's TF32 dots; at padded rank 128 the passes are compute-bound and
# only at parity with XLA's step (within a few per cent either way,
# depending on the card's power limit), while up to 64 they are clearly
# faster end to end (H100 measurements across rank 32-128, f32 and bf16
# X: PERF.md, "Kernels against XLA").
MAX_RANK = 64

# (rows per program, columns per loop step, warps, pipeline stages) for
# the W pass, the W pass with the lagged objective and the objectives;
# (rows per loop step, columns per program, ...) for the H pass.  The
# fastest of sweeps on the H100 at 20000x11000 rank 50, f32 X (PERF.md,
# "Kernels against XLA"); larger tiles exceed a block's shared memory.
TILES = {
    "w": (64, 32, 4, 4),
    "w_obj": (64, 64, 4, 3),
    "obj": (32, 128, 8, 3),
    "h": (64, 64, 4, 3),
}


def _padded_rank(k: int) -> int:
    return max(16, pl.next_power_of_2(k))


def kernel_fits(x, k: int) -> bool:
    """Whether the fused kernels take (x, rank k): a 2-D float32 or
    bfloat16 X and a padded rank of at most ``MAX_RANK``."""
    return (getattr(x, "ndim", 0) == 2
            and x.dtype in (jnp.float32, jnp.bfloat16)
            and _padded_rank(k) <= MAX_RANK)


def _pad_factors(w, h):
    kp = _padded_rank(w.shape[1]) - w.shape[1]
    w = jnp.pad(w.astype(jnp.float32), ((0, 0), (0, kp)))
    h = jnp.pad(h.astype(jnp.float32), ((0, kp), (0, 0)))
    return w, h


def _x_tile(x_ref, r0, c0, bm, bn):
    """(bm, bn) tile of X at (r0, c0) as float32, zero outside X, and its
    mask."""
    m, n = x_ref.shape
    rows = r0 + jnp.arange(bm, dtype=jnp.int32)
    cols = c0 + jnp.arange(bn, dtype=jnp.int32)
    mask = (rows < m)[:, None] & (cols < n)[None, :]
    x = plt.load(x_ref.at[pl.ds(r0, bm), pl.ds(c0, bn)], mask=mask, other=0)
    return x.astype(jnp.float32), mask


def _row_block(ref, r0, bm):
    rows = r0 + jnp.arange(bm, dtype=jnp.int32)
    return plt.load(ref.at[pl.ds(r0, bm), :],
                    mask=(rows < ref.shape[0])[:, None], other=0.0)


def _col_block(ref, c0, bn):
    cols = c0 + jnp.arange(bn, dtype=jnp.int32)
    return plt.load(ref.at[:, pl.ds(c0, bn)],
                    mask=(cols < ref.shape[1])[None, :], other=0.0)


def _kl_term(x, s, mask):
    """Masked KL summand x*log(x/s) - x + s with the reference's
    inf/NaN zeroing (nmf/utils.py:23-26); zero outside X."""
    val = x * jnp.log(x / s)
    val = jnp.where(val == jnp.inf, 0.0, val)
    val = jnp.where(jnp.isnan(val), 0.0, val)
    return jnp.where(mask, val - x + s, 0.0)


def _whole(ref, axis):
    """A full slice of ``ref`` along ``axis`` with an int32 start: stores
    index with one integer type even when x64 is on."""
    return pl.ds(jnp.int32(0), ref.shape[axis])


def _closed_form(a, b, lam):
    """Regularized KL-MUR update 2a / (b + sqrt(b^2 + 4 lam a))
    (nmf/mur.py:25-27)."""
    return 2.0 * a / (b + jnp.sqrt(b * b + 4.0 * lam * a))


# ---------------------------------------------------------------- kernels
#
# Each kernel's grid is (blocks, splits): block i owns bm rows (W pass,
# objectives) or bn columns (H pass) and split s walks its share of the
# tiles along the other axis, writing a partial numerator (or objective
# sum) that XLA adds up.  Splitting the loop axis keeps several programs
# per SM even when the owned axis has few blocks (8192 rows / 64 = 128
# blocks for 132 SMs), at the cost of a small (splits, m, K) partial.


def _split_range(n_tiles, splits):
    """[lo, hi) of the loop tiles that split ``pl.program_id(1)`` walks."""
    per = pl.cdiv(n_tiles, splits)
    lo = pl.program_id(1) * per
    return lo, jnp.minimum(lo + per, n_tiles)


def _w_kl_kernel(x_ref, w_ref, h_ref, num_ref, *obj_ref, bm, bn, splits):
    r0 = pl.program_id(0) * bm
    w = _row_block(w_ref, r0, bm)                          # (bm, K)

    def body(j, carry):
        acc, obj = carry
        c0 = j * bn
        x, mask = _x_tile(x_ref, r0, c0, bm, bn)
        h = _col_block(h_ref, c0, bn)                      # (K, bn)
        s = pl.dot(w, h)
        acc = acc + pl.dot(x / (s + _EPS), h, trans_b=True)
        if obj_ref:
            obj = obj + _kl_term(x, s, mask)
        return acc, obj

    lo, hi = _split_range(pl.cdiv(x_ref.shape[1], bn), splits)
    # the objective accumulates elementwise and reduces once at the end:
    # a block-wide reduction per tile would synchronize every step
    obj0 = jnp.zeros((bm, bn) if obj_ref else (), jnp.float32)
    acc, obj = jax.lax.fori_loop(
        lo, hi, body, (jnp.zeros(w.shape, jnp.float32), obj0))
    rows = r0 + jnp.arange(bm, dtype=jnp.int32)
    plt.store(num_ref.at[pl.program_id(1), pl.ds(r0, bm), _whole(num_ref, 2)],
              acc, mask=(rows < x_ref.shape[0])[:, None])
    if obj_ref:
        obj_ref[0][...] = jnp.sum(obj)


def _h_kl_kernel(x_ref, w_ref, h_ref, num_ref, *, bm, bn, splits):
    c0 = pl.program_id(0) * bn
    h = _col_block(h_ref, c0, bn)                          # (K, bn)

    def body(i, acc):
        r0 = i * bm
        x, _ = _x_tile(x_ref, r0, c0, bm, bn)
        w = _row_block(w_ref, r0, bm)                      # (bm, K)
        s = pl.dot(w, h)
        return acc + pl.dot(w, x / (s + _EPS), trans_a=True)

    lo, hi = _split_range(pl.cdiv(x_ref.shape[0], bm), splits)
    acc = jax.lax.fori_loop(lo, hi, body, jnp.zeros(h.shape, jnp.float32))
    cols = c0 + jnp.arange(bn, dtype=jnp.int32)
    plt.store(num_ref.at[pl.program_id(1), _whole(num_ref, 1), pl.ds(c0, bn)],
              acc, mask=(cols < x_ref.shape[1])[None, :])


def _obj_kernel(x_ref, w_ref, h_ref, obj_ref, *, bm, bn, splits,
                distance_type):
    r0 = pl.program_id(0) * bm
    w = _row_block(w_ref, r0, bm)

    def body(j, obj):
        c0 = j * bn
        x, mask = _x_tile(x_ref, r0, c0, bm, bn)
        s = pl.dot(w, _col_block(h_ref, c0, bn))
        if distance_type == "kl":
            return obj + _kl_term(x, s, mask)
        d = x - s                                           # zero outside X
        return obj + d * d

    lo, hi = _split_range(pl.cdiv(x_ref.shape[1], bn), splits)
    # elementwise accumulation, one reduction at the end (see W pass)
    obj_ref[...] = jnp.sum(jax.lax.fori_loop(
        lo, hi, body, jnp.zeros((bm, bn), jnp.float32)))


# enough programs to keep several per SM (132 SMs on the H100)
_PROGRAMS = 528


def _call(kernel, name, blocks, n_tiles, tiles, out_shape, out_specs,
          interpret):
    """pallas_call over (blocks, splits) on the Triton route; returns the
    call and ``splits``."""
    bm, bn, warps, stages = tiles
    splits = max(1, min(n_tiles, pl.cdiv(_PROGRAMS, blocks)))
    call = pl.pallas_call(
        functools.partial(kernel, bm=bm, bn=bn, splits=splits),
        grid=(blocks, splits),
        out_shape=out_shape(splits),
        out_specs=out_specs,
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=warps, num_stages=stages),
        interpret=interpret,
        name=name,
    )
    return call, splits


def _partial_spec():
    return pl.BlockSpec((None, None), lambda i, s: (s, i))


# jitted so that eager calls (a solver's initial objective) reuse the
# compiled kernel instead of tracing a fresh pallas_call each time
@functools.partial(jax.jit, static_argnames=("with_obj", "tiles", "interpret"))
def _kl_w_pallas(x, w, h, lam, *, with_obj, tiles, interpret):
    m, k = w.shape
    wp, hp = _pad_factors(w, h)
    blocks = pl.cdiv(m, tiles[0])

    def out_shape(splits):
        shapes = [jax.ShapeDtypeStruct((splits,) + wp.shape, jnp.float32)]
        if with_obj:
            shapes.append(jax.ShapeDtypeStruct((splits, blocks), jnp.float32))
        return shapes

    out_specs = [pl.BlockSpec()] + ([_partial_spec()] if with_obj else [])
    call, _ = _call(_w_kl_kernel,
                    "mur_kl_w_pass_obj" if with_obj else "mur_kl_w_pass",
                    blocks, pl.cdiv(x.shape[1], tiles[1]), tiles, out_shape,
                    out_specs, interpret)
    outs = call(x, wp, hp)
    numer = jnp.sum(outs[0], axis=0)[:, :k]
    w_new = _closed_form(w * numer, jnp.sum(h, axis=1)[None, :], lam)
    return (w_new, jnp.sum(outs[1])) if with_obj else w_new


@functools.partial(jax.jit, static_argnames=("tiles", "interpret"))
def _kl_h_pallas(x, w, h, lam, *, tiles, interpret):
    k, n = h.shape
    wp, hp = _pad_factors(w, h)
    call, _ = _call(
        _h_kl_kernel, "mur_kl_h_pass", pl.cdiv(n, tiles[1]),
        pl.cdiv(x.shape[0], tiles[0]), tiles,
        lambda splits: [jax.ShapeDtypeStruct((splits,) + hp.shape,
                                             jnp.float32)],
        [pl.BlockSpec()], interpret)
    (parts,) = call(x, wp, hp)
    numer = jnp.sum(parts, axis=0)[:k]
    return _closed_form(h * numer, jnp.sum(w, axis=0)[:, None], lam)


@functools.partial(jax.jit,
                   static_argnames=("distance_type", "tiles", "interpret"))
def _obj_pallas(x, w, h, distance_type, *, tiles, interpret):
    wp, hp = _pad_factors(w, h)
    blocks = pl.cdiv(x.shape[0], tiles[0])
    call, _ = _call(
        functools.partial(_obj_kernel, distance_type=distance_type),
        f"{distance_type}_objective", blocks, pl.cdiv(x.shape[1], tiles[1]),
        tiles,
        lambda splits: [jax.ShapeDtypeStruct((splits, blocks), jnp.float32)],
        [_partial_spec()], interpret)
    (parts,) = call(x, wp, hp)
    return jnp.sum(parts)


# ------------------------------------------------------------- public ops


def kl_w_update(x, w, h, lam, *, with_obj: bool = False, tiles=None,
                interpret: bool = False):
    """KL-MUR W update (nmf/mur.py:20-27) in one pass over X.

    With ``with_obj`` also returns KL(x, w @ h) of the INCOMING factors —
    free, since the pass forms those W @ H tiles anyway (the 'lagged'
    objective)."""
    tiles = tiles or TILES["w_obj" if with_obj else "w"]
    return _kl_w_pallas(x, w, h, lam, with_obj=with_obj, tiles=tiles,
                        interpret=interpret)


def kl_h_update(x, w, h, lam, *, tiles=None, interpret: bool = False):
    """KL-MUR H update (nmf/mur.py:36-44) in one pass over X."""
    return _kl_h_pallas(x, w, h, lam, tiles=tiles or TILES["h"],
                        interpret=interpret)


def kl_obj(x, w, h, *, use_pallas: bool = False, interpret: bool = False,
           tiles=None):
    """Masked KL objective (nmf/utils.py:21-26)."""
    if use_pallas:
        return _obj_pallas(x, w, h, "kl", tiles=tiles or TILES["obj"],
                           interpret=interpret)
    wh = w @ h
    val = x * jnp.log(x / wh)
    val = jnp.where(val == jnp.inf, 0.0, val)
    val = jnp.where(jnp.isnan(val), 0.0, val)
    return jnp.sum(val - x + wh)


def eu_residual_obj(x, w, h, *, use_pallas: bool = False,
                    interpret: bool = False, tiles=None):
    """0.5 * ||x - w @ h||_F^2."""
    if use_pallas:
        return 0.5 * _obj_pallas(x, w, h, "eu", tiles=tiles or TILES["obj"],
                                 interpret=interpret)
    d = x - w @ h
    return 0.5 * jnp.sum(d * d)


def kl_ratio(x, w, h, *, eps: float = _EPS):
    """x / (w @ h + eps) (MUR-KL ratio, nmf/mur.py:25)."""
    return x / (w @ h + eps)


def kl_ratio_and_obj(x, w, h, *, eps: float = _EPS):
    """(x / (wh + eps), masked-KL objective) from one W @ H."""
    wh = w @ h
    r = x / (wh + eps)
    val = x * jnp.log(x / wh)
    val = jnp.where(val == jnp.inf, 0.0, val)
    val = jnp.where(jnp.isnan(val), 0.0, val)
    return r, jnp.sum(val - x + wh)
