"""The port against the benchmark's plain reference at a tiny size on the
CPU: the same token ids and windows from the synthetic vocabulary, and
the same sentence vectors from the same checkpoint, within the port's
bf16 arithmetic."""

import numpy as np
import pytest
import torch

from perfbench.corpus import Corpus, make_vocab, make_weights, write_checkpoint
from perfbench.reference import minilm as ref_minilm
from perfbench.reference.wordpiece import WordPiece

CFG = {"vocab_size": 30522, "hidden_size": 384, "num_hidden_layers": 2,
       "num_attention_heads": 12, "intermediate_size": 1536, "max_position_embeddings": 512,
       "type_vocab_size": 2, "layer_norm_eps": 1e-12, "model_type": "bert"}
STORE = {"rows": 1024, "topics": 16, "cos_to_centre": 0.8}


@pytest.fixture(scope="module")
def vocab():
    return make_vocab()


def test_vocab_size_and_specials(vocab):
    assert len(vocab) == 30522 and len(set(vocab)) == 30522
    assert vocab[:5] == ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]


def test_tokenizer_and_windows_match_the_port(vocab):
    from memex_tpu_torch.text.segment import segment_text
    from memex_tpu_torch.text.tokenizer import WordPieceTokenizer

    port = WordPieceTokenizer(vocab=vocab)
    ref = WordPiece(vocab)
    corpus = Corpus(7, CFG, STORE, "cpu", vocab)
    text = ". ".join(q for _, q in corpus.queries(120, {"median": 6, "sigma": 0.45, "min": 2,
                                                         "max": 32}))
    text += " Mixed, CASE; and odd-words xqzv!"
    assert port.encode(text) == ref.encode(text)
    assert segment_text(text, port) == [ref.decode(w) for w in ref.windows(text)]
    assert len(ref.windows(text)) > 1


def test_encoder_matches_the_port(vocab, tmp_path):
    from memex_tpu_torch.models.minilm import load_params

    w = make_weights(CFG, 5, "cpu")
    write_checkpoint(str(tmp_path), CFG, w, vocab)
    _, model = load_params(str(tmp_path))
    model = model.cast_to_compute().eval()
    ref = WordPiece(vocab)
    seqs = [ref.encode(" ".join(vocab[200 + i : 200 + i + n])) for i, n in
            enumerate((3, 9, 30))]
    L = max(map(len, seqs))
    ids = torch.zeros((3, L), dtype=torch.int32)
    mask = torch.zeros((3, L), dtype=torch.int32)
    for i, s in enumerate(seqs):
        ids[i, : len(s)] = torch.tensor(s)
        mask[i, : len(s)] = 1
    with torch.inference_mode():
        got = model(ids, mask).float()
    want = ref_minilm.encode_ids(w, CFG, seqs, ref.pad)
    cos = (got * want).sum(1)
    # bf16 dense layers against float32: agreement to ~1e-3 in cosine.
    assert float(cos.min()) > 0.999
    exact = ref_minilm.encode_ids(w, CFG, seqs[:1], ref.pad)
    assert torch.allclose(exact[0], want[0], atol=1e-5)


def test_rows_regenerate_bit_for_bit(vocab):
    c = Corpus(9, CFG, STORE, "cpu", vocab)
    c.centres = torch.nn.functional.normalize(torch.randn(16, 384), dim=1)
    a, ta = c.block(0)
    b, tb = c.block(0)
    assert torch.equal(a, b) and torch.equal(ta, tb)
    cos = (a * c.centres[ta]).sum(1)
    assert abs(float(cos.mean()) - 0.8) < 0.02
    assert np.allclose(a.norm(dim=1).numpy(), 1.0, atol=1e-5)
