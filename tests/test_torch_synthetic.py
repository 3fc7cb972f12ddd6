"""The port's synthetic token stream (``repro_torch.data.synthetic``)
against the JAX package's, on the CPU.

The reference draws its uniform tokens and keep mask from JAX's PRNG; the
port draws them from numpy's, so the streams differ.  What must agree is
the Markov fold on top of a draw: ``markov_fold`` on the reference's own
``rand`` and ``keep`` (reproduced here with ``jax.random`` as
``repro/data/synthetic.py:20-25`` draws them) gives the reference's
tokens bit for bit.  The port's stream is pure and seekable in ``(seed,
step, worker)``, lays workers on a leading axis and is learnable, as the
reference's tests check for the reference's (``tests/test_data.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.data import synth_lm_batch as jsynth  # noqa: E402

from repro_torch.data import (TokenStream, markov_fold,  # noqa: E402
                               synth_lm_batch)


def _ref_draw(seed, step, worker, batch, seq_len, vocab):
    key = jax.random.fold_in(jax.random.fold_in(
        jax.random.PRNGKey(seed), step), worker)
    k1, k2 = jax.random.split(key)
    rand = jax.random.randint(k1, (batch, seq_len + 1), 0, vocab)
    keep = jax.random.bernoulli(k2, 0.75, (batch, seq_len))
    return np.array(rand), np.array(keep)


@pytest.mark.parametrize("case", [(0, 7, 0, 2, 16, 97), (3, 0, 5, 4, 33, 512),
                                  (1, 12345, 2, 3, 64, 151936)])
def test_markov_fold_is_the_references_bit_for_bit(case):
    seed, step, worker, batch, seq, vocab = case
    rand, keep = _ref_draw(seed, step, worker, batch, seq, vocab)
    toks = markov_fold(torch.from_numpy(rand), torch.from_numpy(keep), vocab)
    ref = jsynth(seed, step, batch, seq, vocab, worker=worker)
    assert toks.dtype == torch.int32 and toks.shape == (batch, seq + 1)
    np.testing.assert_array_equal(toks[:, :-1].numpy(),
                                  np.asarray(ref["tokens"]))
    np.testing.assert_array_equal(toks[:, 1:].numpy(),
                                  np.asarray(ref["targets"]))


def test_reference_draw_under_jit_is_its_eager_draw():
    """tests/test_torch_train*.py memoize the reference's draws under
    ``jax.jit``; this holds them to its eager draws."""
    f = jax.jit(jsynth, static_argnums=(2, 3, 4))
    for step, worker in ((0, 0), (5, 3), (10_000_003, 1)):
        a, b = f(0, step, 4, 32, 512, worker), jsynth(0, step, 4, 32, 512,
                                                      worker=worker)
        for k in ("tokens", "targets"):
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


def test_stream_pure_and_seekable():
    b1 = synth_lm_batch(0, 7, batch=2, seq_len=16, vocab=97, worker=1)
    b2 = synth_lm_batch(0, 7, batch=2, seq_len=16, vocab=97, worker=1)
    for k in ("tokens", "targets"):
        assert torch.equal(b1[k], b2[k])
    for other in (synth_lm_batch(0, 8, 2, 16, 97, worker=1),
                  synth_lm_batch(0, 7, 2, 16, 97, worker=2),
                  synth_lm_batch(1, 7, 2, 16, 97, worker=1)):
        assert not torch.equal(b1["tokens"], other["tokens"])
    # seeking: a stream read out of order gives the same batches
    ts = TokenStream(seed=0, batch=2, seq_len=16, vocab=97, n_workers=3)
    later, first = ts(9), ts(0)
    assert torch.equal(later["tokens"], ts(9)["tokens"])
    assert torch.equal(first["tokens"], ts(0)["tokens"])
    for w in range(3):
        want = synth_lm_batch(0, 9, 2, 16, 97, worker=w)
        assert torch.equal(later["tokens"][w], want["tokens"])
        assert torch.equal(later["targets"][w], want["targets"])


def test_token_stream_learnable():
    """``tests/test_data.py:102`` on the port: ~75% of transitions follow
    t' = 7t + 1 mod V."""
    b = synth_lm_batch(0, 7, batch=2, seq_len=16, vocab=97)
    toks, tgts = b["tokens"].numpy(), b["targets"].numpy()
    np.testing.assert_array_equal(toks[:, 1:], tgts[:, :-1])
    assert np.mean(tgts == (toks * 7 + 1) % 97) > 0.6
    big = synth_lm_batch(0, 0, batch=8, seq_len=512, vocab=151936)
    toks, tgts = big["tokens"].numpy(), big["targets"].numpy()
    assert 0.72 < np.mean(tgts == (toks * 7 + 1) % 151936) < 0.78
    assert toks.min() >= 0 and toks.max() < 151936


def test_stream_worker_axis():
    ts = TokenStream(seed=0, batch=2, seq_len=8, vocab=31, n_workers=3)
    b = ts(0)
    assert b["tokens"].shape == b["targets"].shape == (3, 2, 8)
    assert b["tokens"].dtype == torch.int32
    assert b["tokens"].device.type == "cpu"
    assert not torch.equal(b["tokens"][0], b["tokens"][1])
    np.testing.assert_array_equal(b["tokens"][..., 1:].numpy(),
                                  b["targets"][..., :-1].numpy())
