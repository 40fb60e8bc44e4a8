"""The port's MiniLM against the canonical HF implementation
(`transformers.BertModel`), as tests/test_golden_parity.py holds
memex_tpu's: the same all-MiniLM-L12-v2 geometry (12 layers, 384 hidden,
12 heads, 1536 FFN; the vocab shrunk) built from a local BertConfig with
seeded random weights, saved in HF format, loaded through the port's
load_params and tokenizer, mean-pooled and L2-normalised on both sides.
No download: the checkpoint is made here."""

import os

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from memex_tpu_torch.embed import EmbeddingEngine
from memex_tpu_torch.models.minilm import MiniLMConfig, load_params
from memex_tpu_torch.text.tokenizer import WordPieceTokenizer

SENTENCES = [
    "The quick brown fox jumps over the lazy dog.",
    "TPU chips multiply matrices fast!",
    "Semantic search finds meaning, not keywords.",
    "hello world, this is a golden parity test.",
]
_WORDS = (
    "the quick brown fox jump jumps over lazy dog tpu chip chips multiply "
    "multiplies matrice matrices fast semantic search find finds meaning not "
    "keyword keywords hello world this is a golden parity test of sentence "
    "embedding model transformer mean pooling"
).split()
_PIECES = ["##s", "##ing", "##ed", "##er", "##ly", ".", ",", "!", "?", "'"]


@pytest.fixture(scope="module")
def hf_checkpoint(tmp_path_factory):
    d = tmp_path_factory.mktemp("hf_minilm_port")
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + _WORDS + _PIECES
    vocab += [f"tok{i}" for i in range(200)]
    with open(os.path.join(d, "vocab.txt"), "w", encoding="utf-8") as fh:
        fh.write("\n".join(vocab) + "\n")
    cfg = transformers.BertConfig(
        vocab_size=len(vocab), hidden_size=384, num_hidden_layers=12,
        num_attention_heads=12, intermediate_size=1536, hidden_act="gelu",
        max_position_embeddings=512, type_vocab_size=2, layer_norm_eps=1e-12,
    )
    torch.manual_seed(0)
    model = transformers.BertModel(cfg).eval()
    model.save_pretrained(str(d), safe_serialization=True)
    return str(d), model


def _golden(model, ids, mask):
    """sentence-transformers semantics: mean over the mask, L2-normalise."""
    with torch.no_grad():
        out = model(input_ids=ids, attention_mask=mask).last_hidden_state
    m = mask.unsqueeze(-1).float()
    pooled = (out * m).sum(1) / m.sum(1).clamp(min=1e-9)
    return torch.nn.functional.normalize(pooled, dim=-1).numpy()


def _ids(tok, sentences, length=64):
    ids = np.full((len(sentences), length), tok.pad_id, np.int64)
    mask = np.zeros((len(sentences), length), np.int64)
    for i, s in enumerate(sentences):
        w = tok.encode(s, add_special_tokens=True)[:length]
        ids[i, : len(w)] = w
        mask[i, : len(w)] = 1
    return torch.from_numpy(ids), torch.from_numpy(mask)


def test_tokenizer_matches_hf(hf_checkpoint):
    model_dir, _ = hf_checkpoint
    ours = WordPieceTokenizer.from_pretrained_dir(model_dir)
    theirs = transformers.BertTokenizer(os.path.join(model_dir, "vocab.txt"),
                                        do_lower_case=True)
    for s in SENTENCES + ["unknownwordhere multiplies fast!", "a, b. c?"]:
        assert ours.encode(s, add_special_tokens=True) == theirs.encode(s), s


@pytest.mark.parametrize("compute_dtype,min_cos", [("float32", 0.9999), ("bfloat16", 0.995)])
def test_forward_parity_with_hf(hf_checkpoint, compute_dtype, min_cos):
    model_dir, hf_model = hf_checkpoint
    tok = WordPieceTokenizer.from_pretrained_dir(model_dir)
    ids, mask = _ids(tok, SENTENCES)
    golden = _golden(hf_model, ids, mask)
    cfg = MiniLMConfig.from_model_dir(model_dir)
    cfg = MiniLMConfig(**{**cfg.__dict__, "compute_dtype": compute_dtype})
    _, model = load_params(model_dir, cfg)
    with torch.no_grad():
        mine = model.cast_to_compute()(ids, mask).numpy()
    assert mine.shape == golden.shape == (len(SENTENCES), 384)
    cos = np.sum(mine * golden, axis=1)
    assert cos.min() >= min_cos, cos
    # distinct sentences must not all collapse to the same vector
    assert np.abs(golden @ golden.T - np.eye(len(SENTENCES))).max() < 1.0


def test_engine_end_to_end_parity(hf_checkpoint):
    """EmbeddingEngine(model_dir=...) -- the path the service uses, bf16
    dense layers -- agrees with the oracle on encode_single."""
    model_dir, hf_model = hf_checkpoint
    engine = EmbeddingEngine(model_dir=model_dir, max_seq_length=64, device="cpu")
    theirs = transformers.BertTokenizer(os.path.join(model_dir, "vocab.txt"),
                                        do_lower_case=True)
    for s in SENTENCES:
        enc = theirs(s, return_tensors="pt")
        golden = _golden(hf_model, enc["input_ids"], enc["attention_mask"])[0]
        assert float(engine.encode_single(s) @ golden) >= 0.995, s
