"""A plain BERT WordPiece tokenizer and memex's document windows.

HF BertTokenizer's pipeline (lowercase, split on whitespace and
punctuation, greedy longest-match pieces with "##" continuations) and
its decode (pieces joined by spaces, "##" glued, punctuation re-attached
as memex does), written again from the published behaviour. The
benchmark's texts are lowercase ASCII, so accent stripping and CJK
isolation are left out: `tokenize` refuses other text.
"""

from __future__ import annotations

SPECIALS = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")
_PUNCT = set("!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~")


class WordPiece:
    def __init__(self, vocab: list[str]):
        self.vocab = list(vocab)
        self.index = {tok: i for i, tok in enumerate(self.vocab)}
        self.pad, self.unk, self.cls, self.sep = (self.index[s] for s in SPECIALS[:4])

    def _words(self, text: str) -> list[str]:
        if not text.isascii():
            raise ValueError("the reference tokenizer takes ASCII text only")
        out, word = [], []
        for ch in text.lower():
            if ch.isspace() or not ch.isprintable():
                if word:
                    out.append("".join(word))
                    word = []
            elif ch in _PUNCT:
                if word:
                    out.append("".join(word))
                    word = []
                out.append(ch)
            else:
                word.append(ch)
        if word:
            out.append("".join(word))
        return out

    def _pieces(self, word: str) -> list[int]:
        if len(word) > 100:
            return [self.unk]
        ids, start = [], 0
        while start < len(word):
            for end in range(len(word), start, -1):
                piece = word[start:end] if start == 0 else "##" + word[start:end]
                if piece in self.index:
                    ids.append(self.index[piece])
                    start = end
                    break
            else:
                return [self.unk]
        return ids

    def encode(self, text: str, specials: bool = True) -> list[int]:
        ids = [i for w in self._words(text) for i in self._pieces(w)]
        return [self.cls] + ids + [self.sep] if specials else ids

    def decode(self, ids: list[int]) -> str:
        skip = {self.index[s] for s in SPECIALS}
        parts: list[str] = []
        for i in ids:
            if i in skip:
                continue
            tok = self.vocab[i]
            if tok.startswith("##") and parts:
                parts[-1] += tok[2:]
            else:
                parts.append(tok[2:] if tok.startswith("##") else tok)
        text = " ".join(parts)
        for p in ",.!?;:')]}%":
            text = text.replace(" " + p, p)
        for p in "([{$#":
            text = text.replace(p + " ", p)
        return text.replace("' ", "'")

    def windows(self, text: str, max_length: int = 256, stride: int = 86) -> list[list[int]]:
        """memex's windows: at most max_length ids with [CLS] and [SEP],
        neighbours sharing `stride` content ids; an empty text is one [UNK]."""
        ids = self.encode(text, specials=False) or [self.unk]
        content = max_length - 2
        out, start = [], 0
        while True:
            out.append([self.cls] + ids[start : start + content] + [self.sep])
            if start + content >= len(ids):
                return out
            start += content - stride
