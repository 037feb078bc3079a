"""The port's synthetic data vs the JAX reference's: ``SyntheticLM.batch``
(uniform and Dirichlet topic mixes, several seeds and shapes) and
``dirichlet_client_mixes``, bit for bit (both are NumPy generators drawn in
the same order)."""
import numpy as np
import pytest

from repro.data.synthetic import SyntheticLM as JSyntheticLM
from repro.data.synthetic import dirichlet_client_mixes as jmixes
from repro_torch.data import SyntheticLM, dirichlet_client_mixes


@pytest.mark.parametrize("vocab,seq,seed,B,bseed", [
    (128, 16, 0, 4, 0), (128, 16, 2, 8, 999), (256, 33, 1, 3, 7),
    (128256, 64, 0, 2, 5),        # llama3.2-1b's vocabulary
])
@pytest.mark.parametrize("mixed", [False, True])
def test_batch_equals_reference(vocab, seq, seed, B, bseed, mixed):
    mix = dirichlet_client_mixes(4, 8, seed=seed)[seed % 4] if mixed else None
    got = SyntheticLM(vocab=vocab, seq_len=seq, seed=seed).batch(
        B, topic_mix=mix, seed=bseed)
    want = JSyntheticLM(vocab=vocab, seq_len=seq, seed=seed).batch(
        B, topic_mix=mix, seed=bseed)
    assert set(got) == {"tokens", "labels"}
    for k in got:
        assert got[k].dtype == want[k].dtype == np.int32
        assert got[k].shape == (B, seq)
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(got["tokens"][:, 1:], got["labels"][:, :-1])
    assert got["tokens"].min() >= 0 and got["tokens"].max() < vocab


@pytest.mark.parametrize("n,topics,alpha,seed", [
    (256, 8, 0.3, 0), (16, 4, 1.0, 3), (5, 8, 0.05, 11)])
def test_client_mixes_equal_reference(n, topics, alpha, seed):
    got = dirichlet_client_mixes(n, topics, alpha=alpha, seed=seed)
    want = jmixes(n, topics, alpha=alpha, seed=seed)
    assert got.shape == (n, topics)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got.sum(axis=1), 1.0, rtol=1e-12)


def test_topic_probs_equal_reference():
    got = SyntheticLM(vocab=1000, seq_len=8, seed=4)._topic_probs
    want = JSyntheticLM(vocab=1000, seq_len=8, seed=4)._topic_probs
    assert len(got) == len(want) == 8
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
