"""PyTorch port: the episode head (plain version of K2) against the JAX
package's ``_batched_episode_scores_xla`` and, in interpret mode, its Pallas
kernel; the ``autograd.Function``'s gradients against ``jax.grad`` of the
XLA head. The CUDA kernel itself is held against the plain version on the
card (``test_torch_port_cuda.py``, ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_few_shot_learning_tpu.ops import protohead as jph
from audio_few_shot_learning_tpu_torch.ops import protohead as tph

# Same algorithm, another summation order: 1e-4 absolute / 1e-5 relative.
ATOL, RTOL = 1e-4, 1e-5


def _episode(seed=0, e=3, s=12, q=7, d=32, n=4, empty_class=True):
    rng = np.random.default_rng(seed)
    sup = rng.standard_normal((e, s, d)).astype(np.float32)
    qry = rng.standard_normal((e, q, d)).astype(np.float32)
    hi = n - 1 if empty_class else n  # class n-1 stays empty
    labels = rng.integers(0, hi, (e, s)).astype(np.int64)
    return sup, labels, qry, n


def test_plain_matches_xla_head():
    sup, labels, qry, n = _episode()
    want = np.asarray(
        jph._batched_episode_scores_xla(jnp.asarray(sup), jnp.asarray(labels), jnp.asarray(qry), n)
    )
    got = tph.batched_episode_scores_reference(
        torch.from_numpy(sup), torch.from_numpy(labels), torch.from_numpy(qry), n
    ).numpy()
    assert got.shape == (3, 7, n)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_plain_matches_pallas_interpret():
    from jax.experimental.pallas import tpu as pltpu

    sup, labels, qry, n = _episode(seed=1, e=2, s=25, q=25, d=64, n=5, empty_class=False)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jph._batched_episode_scores_pallas(
            jnp.asarray(sup), jnp.asarray(labels), jnp.asarray(qry), n
        ))
    got = tph.batched_episode_scores_reference(
        torch.from_numpy(sup), torch.from_numpy(labels), torch.from_numpy(qry), n
    ).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_prototypes_match_jax_with_empty_and_foreign_labels():
    """Empty classes give zero prototypes; labels outside [0, n) are ignored."""
    rng = np.random.default_rng(2)
    feats = rng.standard_normal((9, 8)).astype(np.float32)
    labels = np.array([0, 0, 2, 2, 2, 5, -1, 0, 2])
    want = np.asarray(jph.compute_prototypes(jnp.asarray(feats), jnp.asarray(labels), 4))
    got = tph.compute_prototypes(torch.from_numpy(feats), torch.from_numpy(labels), 4).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert not got[1].any() and not got[3].any()


def test_fused_scores_gradients_match_jax_grad():
    """The autograd.Function's backward (the closed-form VJP) against
    jax.grad of the XLA head, atol 1e-4. Its forward is the CUDA kernel; on
    the CPU it takes the plain version."""
    sup, labels, qry, n = _episode(seed=3)
    cot = np.random.default_rng(4).standard_normal((3, 7, n)).astype(np.float32)

    def loss(s, q):
        return jnp.sum(jph._batched_episode_scores_xla(s, jnp.asarray(labels), q, n) * cot)

    want_s, want_q = jax.grad(loss, argnums=(0, 1))(jnp.asarray(sup), jnp.asarray(qry))
    s = torch.from_numpy(sup).requires_grad_(True)
    q = torch.from_numpy(qry).requires_grad_(True)
    (tph._FusedScores.apply(s, torch.from_numpy(labels), q, n) * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(want_s), atol=1e-4, rtol=0)
    np.testing.assert_allclose(q.grad.numpy(), np.asarray(want_q), atol=1e-4, rtol=0)


def test_batched_episode_scores_takes_plain_version_on_cpu():
    sup, labels, qry, n = _episode(seed=5)
    args = (torch.from_numpy(sup), torch.from_numpy(labels), torch.from_numpy(qry), n)
    torch.testing.assert_close(
        tph.batched_episode_scores(*args), tph.batched_episode_scores_reference(*args)
    )


def test_kernel_wrapper_refuses_cpu_tensors():
    sup, labels, qry, n = _episode(seed=6)
    with pytest.raises(ValueError, match="CUDA"):
        tph.episode_scores_cuda(
            torch.from_numpy(sup), torch.from_numpy(labels), torch.from_numpy(qry), n
        )
