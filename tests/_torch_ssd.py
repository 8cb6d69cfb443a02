"""The reference's SSD decay matrix with its mask taken before the exp, as
the port's ``models/ssm.py::_segsum_decay`` takes it, for the tests that
hold the port's Mamba-2 gradients against ``jax.grad``.

The reference (``src/repro/models/ssm.py::_segsum_decay``) computes
``where(mask, exp(diff), 0)``.  Above the diagonal ``diff`` is a sum of
decays' negated logs; where it passes about 88, ``exp`` overflows f32,
the masked inf takes a zero gradient, and 0 x inf makes the whole
gradient NaN.  Masking first gives the same values (exp(-inf) = 0) with
a finite gradient.  Patch it in with ``monkeypatch.setattr(jax_ssm,
"_segsum_decay", segsum_decay_masked_first)``; the reference's files stay
as they are."""
import jax.numpy as jnp


def segsum_decay_masked_first(log_a):
    Q = log_a.shape[-1]
    cs = jnp.cumsum(log_a, axis=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = jnp.tril(jnp.ones((Q, Q), bool))
    return jnp.exp(jnp.where(mask, diff, -jnp.inf))
