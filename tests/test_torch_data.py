"""PyTorch port, the LM data stream: ``repro_torch.data.TokenStream``
against the JAX package's ``repro.data.TokenStream`` (numpy on both sides,
no JAX needed): batches byte for byte, stubs included, and the cursor."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.data import TokenStream as JStream  # noqa: E402
from repro_torch.data import TokenStream  # noqa: E402

KINDS = [dict(), dict(enc_seq=24, d_model=16), dict(n_vis_tokens=12, d_model=16)]


def _same(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        assert a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("seed", [0, 3, 12345])
@pytest.mark.parametrize("kind", range(len(KINDS)))
def test_batches_byte_equal_to_jax(seed, kind):
    """Three steps of each seed: tokens, labels (the tokens shifted by one)
    and the encoder or vision stub's inputs, identical bytes and dtypes."""
    kw = dict(vocab_size=503, global_batch=3, seq_len=17, seed=seed, **KINDS[kind])
    ours, theirs = TokenStream(**kw), JStream(**kw)
    for _ in range(3):
        a, b = ours.next_batch(), theirs.next_batch()
        _same(a, b)
        assert a["tokens"].dtype == np.int32
        np.testing.assert_array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    assert ours.state() == theirs.state() == {"seed": seed, "step": 3}


def test_restore_continues_the_sequence():
    """A stream restored from another's state() gives that stream's next
    batches, as the JAX one does from the same state."""
    kw = dict(vocab_size=1000, global_batch=2, seq_len=8, enc_seq=5, d_model=4)
    a = TokenStream(seed=7, **kw)
    for _ in range(4):
        a.next_batch()
    b, j = TokenStream(seed=0, **kw), JStream(seed=0, **kw)
    b.restore(a.state())
    j.restore(a.state())
    for _ in range(2):
        want = a.next_batch()
        _same(b.next_batch(), want)
        _same(j.next_batch(), want)
