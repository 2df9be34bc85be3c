"""Shared solver-driver machinery.

The reference drives every solver with a sequential Python loop that
appends to ``obj_history``, prints, and early-exits on a convergence check
(reference: nmf/mur.py:119-143, nmf/anls.py:111-132, nmf/admm.py:292-342,
nmf/ao_admm.py:259-308).  Redesign: each solver's whole
iteration body is one jitted function and the loop is a
``lax.while_loop`` whose predicate fuses the max-iteration bound, an
optional block bound (for periodic checkpointing), and the convergence
flag.  ``obj_history`` becomes a preallocated ``(max_iter+1,)`` buffer
updated with a dynamic index — no host round-trips inside the loop.

Blocked execution: the host driver calls the jitted loop in blocks of
``block_size`` iterations.  With ``block_size=None`` the entire run is a
single device dispatch; with a finite block size the host regains control
between blocks to write checkpoints / emit metrics, while per-iteration
convergence semantics stay identical (the predicate is evaluated every
iteration on device either way).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.convergence import converged as _converged


class LoopCarry(NamedTuple):
    """Generic solver loop state.

    i: number of completed iterations (reference's returned ``i`` is
       ``carry.i - 1``, the index of the last executed iteration).
    obj: objective after the latest iteration (obj_buf[i]).
    converged: sticky convergence flag.
    obj_buf: (max_iter+1,) objective trace; obj_buf[0] is the init value.
    inner: solver-specific state pytree (factors, duals, cached ratios...).
    """

    i: jnp.ndarray
    obj: jnp.ndarray
    converged: jnp.ndarray
    obj_buf: jnp.ndarray
    inner: Any


def inner_loop(body: Callable, init_state, n_iter: int, style: str):
    """Early-terminating inner loop in one of two lowering styles.

    ``body(state) -> (new_state, done_now)``.

    'while'       ``lax.while_loop`` that stops as soon as done — the
                  natural form, with a data-dependent loop level.
    'fori_masked' fixed-trip ``lax.fori_loop`` carrying a done flag and
                  freezing the state once done.  Identical iterates to
                  'while' (a frozen state IS the early-exited state);
                  the fixed trip removes one data-dependent loop level.
                  Cost: the remaining (n_iter - t) masked steps still
                  execute.
    """
    done0 = jnp.asarray(False)
    if style == "while":
        def cond(c):
            j, _, done = c
            return jnp.logical_and(j < n_iter, jnp.logical_not(done))

        def wbody(c):
            j, state, _ = c
            new_state, done_now = body(state)
            return (j + 1, new_state, done_now)

        _, state, _ = jax.lax.while_loop(
            cond, wbody, (jnp.asarray(0, jnp.int32), init_state, done0))
        return state
    if style != "fori_masked":
        raise ValueError("style must be 'while' or 'fori_masked'")

    def fbody(j, c):
        state, done = c
        new_state, done_now = body(state)
        frozen = jax.tree.map(
            lambda old, new: jnp.where(done, old, new), state, new_state)
        return (frozen, jnp.logical_or(done, done_now))

    state, _ = jax.lax.fori_loop(0, n_iter, fbody, (init_state, done0))
    return state


def host_array(a) -> np.ndarray:
    """``np.asarray`` that also works for multi-process global arrays.

    In a ``jax.distributed`` run a GSPMD result can span devices owned
    by other processes; fetching it directly raises.  Gather the global
    value with ``process_allgather`` in that case — every process
    returns the full (identical) array, matching single-process
    semantics.
    """
    try:
        return np.asarray(a)
    except RuntimeError:
        from jax.experimental import multihost_utils

        return np.asarray(multihost_utils.process_allgather(a, tiled=True))


def verbose_precision(verbose, tol1, tol2):
    """Encode the reference's per-iteration print precision into the
    static ``verbose`` arg (zero block-signature churn).

    The reference derives decimal places from min(tol1, tol2)
    (nmf/mur.py:93-95): the exponent for tols < 1, else 2.  Returns
    False when not verbose, else that precision as a truthy int that
    while_block/host loops decode; tol <= 0 (our extension — the
    reference crashes there) caps at 12 places.
    """
    if not verbose:
        return False
    tol = min(float(tol1), float(tol2))
    if tol >= 1:
        return 2
    if tol <= 0:
        return 12
    return max(int(format(tol, "e").split("-")[1]), 1)


def init_carry(obj0, max_iter: int, inner) -> LoopCarry:
    obj0 = jnp.asarray(obj0)
    obj_buf = jnp.full((max_iter + 1,), jnp.nan, dtype=obj0.dtype)
    obj_buf = obj_buf.at[0].set(obj0)
    return LoopCarry(
        i=jnp.asarray(0, dtype=jnp.int32),
        obj=obj0,
        converged=jnp.asarray(False),
        obj_buf=obj_buf,
        inner=inner,
    )


def while_block(
    step_fn: Callable[[Any, jnp.ndarray], tuple[Any, jnp.ndarray]],
    carry: LoopCarry,
    stop_i,
    tol1,
    tol2,
    *,
    min_iter: int,
    max_iter: int,
    verbose: bool = False,
) -> LoopCarry:
    """Run the solver loop until stop_i / max_iter / convergence.

    ``step_fn(inner, i) -> (inner, obj)`` performs one full solver
    iteration.  Convergence semantics match the reference exactly: checked
    only when ``i > min_iter`` (strict, nmf/mur.py:131), comparing the new
    objective against the previous one with (tol1, tol2) per
    nmf/utils.py:4-15, and the flag stops the loop *after* the iteration
    that triggered it.

    Objective-skipping steps (opt-in solver cadence knobs such as MUR's
    ``objective_every``) return NaN for skipped iterations: a NaN
    objective is recorded in the trace as-is but neither enters the
    convergence comparison nor displaces the held last real objective —
    the next real value is compared against the previous real one.  A
    genuinely diverging run whose objective *becomes* NaN behaves as
    before only while it stays NaN (the check never fires and the loop
    runs out its budget); if it later recovers to a finite value, that
    value is compared against the held pre-NaN objective, which can
    fire the tol2 branch one observation earlier than the pre-NaN-hold
    behavior.  Consequently a NaN entry in ``obj_history`` means
    "skipped or diverged at that iteration" — disambiguate by whether
    the run used ``objective_every > 1``.
    """
    stop_i = jnp.asarray(stop_i, dtype=jnp.int32)

    def cond(c: LoopCarry):
        return jnp.logical_and(
            c.i < jnp.minimum(stop_i, max_iter), jnp.logical_not(c.converged)
        )

    def body(c: LoopCarry):
        inner, obj = step_fn(c.inner, c.i)
        obj_buf = c.obj_buf.at[c.i + 1].set(obj)
        real = jnp.logical_not(jnp.isnan(obj))
        conv = jnp.logical_and(
            real,
            jnp.logical_and(c.i > min_iter, _converged(obj, c.obj, tol1, tol2)),
        )
        if verbose:
            # Print the RAW objective, before the NaN-hold below: with
            # objective_every > 1 a skipped iteration then prints a
            # visible nan instead of silently repeating the held value
            # (which would be indistinguishable from a stalled solver).
            if verbose is True:
                jax.debug.print("[{i}]: {o}", i=c.i, o=obj)
            else:
                # reference print parity: decimal places derived from
                # min(tol1, tol2) (nmf/mur.py:93-95,128), encoded by the
                # facade as an int in the static ``verbose`` arg via
                # verbose_precision()
                jax.debug.print("[{i}]: {o:.%df}" % int(verbose),
                                i=c.i, o=obj)
        obj = jnp.where(real, obj, c.obj)
        return LoopCarry(c.i + 1, obj, conv, obj_buf, inner)

    return jax.lax.while_loop(cond, body, carry)


def drive(
    run_block: Callable[..., LoopCarry],
    carry: LoopCarry,
    *,
    max_iter: int,
    block_size: Optional[int] = None,
    on_block_end: Optional[Callable[[LoopCarry], None]] = None,
) -> LoopCarry:
    """Host-side blocked driver around a jitted ``run_block(carry, stop_i)``."""
    block = max_iter if block_size is None else max(1, int(block_size))
    i = 0
    while True:
        stop = min(i + block, max_iter)
        carry = run_block(carry, stop)
        i = int(carry.i)
        if on_block_end is not None:
            on_block_end(carry)
        if i >= max_iter or bool(carry.converged):
            return carry


def run_loop(
    run_block: Callable[..., LoopCarry],
    carry: LoopCarry,
    *,
    max_iter: int,
    block_size: Optional[int] = None,
    on_block_end: Optional[Callable[[LoopCarry], None]] = None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: Optional[int] = None,
    resume: bool = False,
    config_tag: Optional[str] = None,
) -> LoopCarry:
    """drive() plus optional checkpoint/resume.

    With ``checkpoint_path`` set, the carry is saved atomically every block
    (block size defaults to ``checkpoint_every`` or 500) and, when
    ``resume=True`` and a checkpoint exists, restored before running — the
    loop continues from the saved iteration with identical semantics.
    ``config_tag`` (typically ``repr(experiment)``) is stored with each
    checkpoint and verified on resume, so a checkpoint from a different
    configuration is rejected even when shapes coincide.
    """
    if checkpoint_path:
        from ..io.checkpoint import checkpoint_exists, load_state, save_state

        if resume and checkpoint_exists(checkpoint_path):
            carry = load_state(checkpoint_path, carry, expected_meta=config_tag)
        if block_size is None:
            block_size = checkpoint_every or 500

        user_cb = on_block_end

        def on_block_end(c):
            save_state(checkpoint_path, c, meta=config_tag)
            if user_cb is not None:
                user_cb(c)

    return drive(
        run_block, carry, max_iter=max_iter, block_size=block_size,
        on_block_end=on_block_end,
    )


def finalize_history(carry: LoopCarry) -> tuple[int, list]:
    """Convert carry to the reference's (i, obj_history) convention."""
    completed = int(carry.i)
    obj_history = list(host_array(carry.obj_buf)[: completed + 1])
    return completed - 1, obj_history
