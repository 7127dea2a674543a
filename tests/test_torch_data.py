"""The port's token corpus (``repro_torch.data.tokens``) against the JAX
package's: the same seeds give the same batches, bit for bit, and the
corpus tests of ``test_data.py`` hold on the port."""
import numpy as np
import pytest

from repro.data.tokens import MarkovCorpus as JCorpus
from repro_torch.data.tokens import MarkovCorpus


@pytest.mark.parametrize("vocab,branching,seed,batch,seq", [
    (128, 4, 0, 4, 32), (49152, 4, 0, 8, 64), (32, 2, 5, 3, 17), (151936, 6, 3, 2, 9)])
def test_markov_batches_equal_jax(vocab, branching, seed, batch, seq):
    jit = JCorpus(vocab, branching, seed).batches(batch, seq, seed=seed + 1)
    tit = MarkovCorpus(vocab, branching, seed).batches(batch, seq, seed=seed + 1)
    for _ in range(3):
        want, got = next(jit), next(tit)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])


def test_markov_corpus_learnable_structure():
    c = MarkovCorpus(vocab=64, branching=2, seed=0)
    rng = np.random.default_rng(0)
    toks = c.sample(rng, 100, 20)
    # each token has at most `branching` distinct successors
    succ = {}
    for row in toks:
        for a, b in zip(row[:-1], row[1:]):
            succ.setdefault(int(a), set()).add(int(b))
    assert max(len(v) for v in succ.values()) <= 2


def test_markov_batches_shapes():
    c = MarkovCorpus(vocab=32, seed=1)
    b = next(c.batches(4, 16))
    assert b["tokens"].shape == (4, 16)
    assert b["labels"].shape == (4, 16)
    assert (b["labels"][:, :-1] == b["tokens"][:, 1:]).all()
