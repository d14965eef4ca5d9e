import numpy as np
import jax
import jax.numpy as jnp
import pytest

import corpus
from deflate_jax.ops import lz77 as LZ
from deflate_jax.utils.tables import BLOCK_SIZE


def _reconstruct(block, blen, length, dist, mark):
    """Replay the token stream like an inflate would; assert validity."""
    out = []
    i = 0
    ntok = 0
    while i < blen:
        assert mark[i], f"position {i} must start a token"
        ntok += 1
        if length[i] >= 3:
            L, D = int(length[i]), int(dist[i])
            assert 1 <= D <= i and L <= 258 and i + L <= blen
            for j in range(L):
                out.append(out[i - D + j])
            i += L
        else:
            out.append(int(block[i]))
            i += 1
    assert mark.sum() == ntok
    return bytes(out)


def _run(data: bytes, K=4, lazy=False):
    blen = len(data)
    block = np.zeros(BLOCK_SIZE, np.uint8)
    block[:blen] = np.frombuffer(data, np.uint8)
    length, dist = jax.jit(lambda b, l: LZ.find_matches(b, l, K))(
        jnp.array(block), jnp.int32(blen))
    if lazy:
        length, dist = LZ.lazy_filter(length, dist)
    mark, len_adj = LZ.greedy_parse(length, jnp.int32(blen))
    return _reconstruct(block, blen, np.asarray(len_adj), np.asarray(dist),
                        np.asarray(mark))


CORPORA = {
    "random": bytes(np.random.default_rng(1).integers(0, 256, 5000).astype(np.uint8)),
    "text": (b"the quick brown fox jumps over the lazy dog. " * 200)[:9000],
    "runs": b"a" * 4000 + b"b" * 100 + b"ab" * 2000,
    "empty_tail": b"xyz",
}


@pytest.mark.parametrize("name", list(CORPORA))
@pytest.mark.parametrize("lazy", [False, True])
def test_tokens_reconstruct_input(name, lazy):
    data = CORPORA[name]
    assert _run(data, K=4, lazy=lazy) == data


def test_reference_corpus_file():
    """The bitmap fixture (row-stride repeats) parses into tokens that
    rebuild it."""
    data = corpus.picture_bitmap()
    assert len(data) == 21654
    assert _run(data, K=8, lazy=True) == data


def test_max_match_length_cap():
    data = b"q" * 3000  # one long run: matches must cap at 258
    blen = len(data)
    block = np.zeros(BLOCK_SIZE, np.uint8)
    block[:blen] = np.frombuffer(data, np.uint8)
    length, dist = LZ.find_matches(jnp.array(block), jnp.int32(blen), 4)
    length = np.asarray(length)
    assert length.max() == 258
    assert _run(data) == data


def test_compression_quality_vs_naive():
    # repetitive text should parse to far fewer tokens than bytes
    data = CORPORA["text"]
    blen = len(data)
    block = np.zeros(BLOCK_SIZE, np.uint8)
    block[:blen] = np.frombuffer(data, np.uint8)
    length, _ = LZ.find_matches(jnp.array(block), jnp.int32(blen), 4)
    mark, _ = LZ.greedy_parse(length, jnp.int32(blen))
    assert np.asarray(mark).sum() < blen // 20
