"""BERT-family WordPiece tokenizer, self-contained.

Host copy of ``densephrases_tpu/data/tokenization.py``: the port never imports the JAX
package, whose ``__init__`` imports jax. Keep the two in step.

The reference leans on HF ``transformers`` tokenizers downloaded from the hub
(ref: densephrases/utils/squad_utils.py feature conversion). This framework is
offline-first: the tokenizer is implemented here (BERT basic+wordpiece
semantics), reads a plain ``vocab.txt``, and a vocab can be *trained* from a
corpus via the ``tokenizers`` Rust library when no pretrained vocab exists.

Special-token layout matches BERT: [PAD]=0 style ids come from the vocab file;
encode(text_a, text_b) produces [CLS] a [SEP] b [SEP] with token_type_ids.
"""

from __future__ import annotations

import os
import unicodedata
from typing import Dict, List, Optional, Tuple

SPECIAL_TOKENS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]


def _is_whitespace(ch):
    return ch in (" ", "\t", "\n", "\r") or unicodedata.category(ch) == "Zs"


def _is_control(ch):
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch):
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


class BasicTokenizer:
    """BERT basic tokenizer: clean, lowercase/strip-accents, split punctuation."""

    def __init__(self, do_lower_case: bool = True):
        self.do_lower_case = do_lower_case

    def tokenize(self, text: str) -> List[str]:
        text = self._clean(text)
        text = self._pad_cjk(text)
        tokens = []
        for tok in text.split():
            if self.do_lower_case:
                tok = tok.lower()
                tok = self._strip_accents(tok)
            tokens.extend(self._split_punc(tok))
        return [t for t in tokens if t]

    @staticmethod
    def _clean(text):
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    @staticmethod
    def _strip_accents(text):
        text = unicodedata.normalize("NFD", text)
        return "".join(ch for ch in text if unicodedata.category(ch) != "Mn")

    @staticmethod
    def _is_cjk(cp: int) -> bool:
        # CJK unicode blocks per BERT's tokenize_chinese_chars semantics
        return (
            0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
            or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F
        )

    @classmethod
    def _pad_cjk(cls, text):
        """Space-pad CJK ideographs so each becomes its own token — matches
        HF BasicTokenizer's tokenize_chinese_chars."""
        if all(ord(ch) < 0x3400 for ch in text):  # fast ASCII/Latin path
            return text
        out = []
        for ch in text:
            if cls._is_cjk(ord(ch)):
                out.append(f" {ch} ")
            else:
                out.append(ch)
        return "".join(out)

    @staticmethod
    def _split_punc(text):
        out, buf = [], []
        for ch in text:
            if _is_punctuation(ch):
                if buf:
                    out.append("".join(buf))
                    buf = []
                out.append(ch)
            else:
                buf.append(ch)
        if buf:
            out.append("".join(buf))
        return out


class WordPieceTokenizer:
    """Greedy longest-match-first WordPiece over a vocab.txt."""

    def __init__(self, vocab: Dict[str, int], do_lower_case: bool = True,
                 unk_token: str = "[UNK]", max_chars_per_word: int = 100):
        self.vocab = vocab
        self.inv_vocab = {v: k for k, v in vocab.items()}
        self.basic = BasicTokenizer(do_lower_case)
        self.do_lower_case = do_lower_case
        self.unk_token = unk_token
        self.max_chars_per_word = max_chars_per_word
        self.pad_token_id = vocab.get("[PAD]", 0)
        self.unk_token_id = vocab.get(unk_token, 1)
        self.cls_token_id = vocab.get("[CLS]", 2)
        self.sep_token_id = vocab.get("[SEP]", 3)
        self.mask_token_id = vocab.get("[MASK]", 4)

    # -------- construction --------
    @classmethod
    def from_vocab_file(cls, path: str, do_lower_case: bool = True):
        vocab = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                tok = line.rstrip("\n")
                if tok:
                    vocab[tok] = i
        return cls(vocab, do_lower_case)

    def save_vocab(self, path: str):
        with open(path, "w", encoding="utf-8") as f:
            for tok, _ in sorted(self.vocab.items(), key=lambda kv: kv[1]):
                f.write(tok + "\n")

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    # -------- core tokenization --------
    def wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_chars_per_word:
            return [self.unk_token]
        out = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [self.unk_token]
            out.append(cur)
            start = end
        return out

    def tokenize(self, text: str) -> List[str]:
        out = []
        for tok in self.basic.tokenize(text):
            out.extend(self.wordpiece(tok))
        return out

    def tokenize_word(self, word: str) -> List[str]:
        """Tokenize one whitespace word (basic-split then wordpiece), keeping
        the mapping usable for offset tracking."""
        out = []
        for tok in self.basic.tokenize(word):
            out.extend(self.wordpiece(tok))
        return out

    def convert_tokens_to_ids(self, tokens: List[str]) -> List[int]:
        return [self.vocab.get(t, self.unk_token_id) for t in tokens]

    def convert_ids_to_tokens(self, ids: List[int]) -> List[str]:
        return [self.inv_vocab.get(i, self.unk_token) for i in ids]

    # -------- fast batch path (Rust `tokenizers` backend) --------
    def _fast_backend(self):
        """Build (once) a Rust WordPiece tokenizer over the same vocab —
        used for offset-free batch encoding (queries); the context path
        keeps the word-by-word python tokenization that offset tracking
        relies on."""
        if getattr(self, "_fast", None) is None:
            try:
                from tokenizers import Tokenizer, models, normalizers, pre_tokenizers

                tok = Tokenizer(models.WordPiece(
                    self.vocab, unk_token=self.unk_token))
                # BertNormalizer = clean_text + CJK-char isolation +
                # (lowercase + strip accents) — the same pipeline as our
                # python BasicTokenizer, including _pad_cjk.
                tok.normalizer = normalizers.BertNormalizer(
                    clean_text=True, handle_chinese_chars=True,
                    strip_accents=self.do_lower_case,
                    lowercase=self.do_lower_case)
                # Whitespace() keeps punctuation runs together; BERT basic
                # tokenization isolates every punctuation char — add an
                # isolating Punctuation pre-tokenizer so the fast (query)
                # path tokenizes identically to the python (context) path.
                tok.pre_tokenizer = pre_tokenizers.Sequence(
                    [pre_tokenizers.WhitespaceSplit(),
                     pre_tokenizers.Punctuation(behavior="isolated")])
                self._fast = tok
            except Exception:  # noqa: BLE001 — fall back to python path
                self._fast = False
        return self._fast or None

    def encode_batch_ids(self, texts: List[str]) -> List[List[int]]:
        """Batch-tokenize plain texts to ids (no special tokens, no offsets).
        Rust-backed when available; python fallback otherwise."""
        fast = self._fast_backend()
        if fast is not None:
            return [enc.ids for enc in fast.encode_batch(texts)]
        return [self.convert_tokens_to_ids(self.tokenize(t)) for t in texts]

    def encode(self, text_a: str, text_b: Optional[str] = None,
               max_length: int = 512) -> Tuple[List[int], List[int], List[int]]:
        """[CLS] a [SEP] (b [SEP]) → (input_ids, attention_mask, token_type_ids)."""
        ids_a = self.convert_tokens_to_ids(self.tokenize(text_a))
        ids_b = self.convert_tokens_to_ids(self.tokenize(text_b)) if text_b else []
        budget = max_length - 2 - (1 if ids_b else 0)
        if ids_b:
            # truncate longest-first
            while len(ids_a) + len(ids_b) > budget:
                if len(ids_a) >= len(ids_b):
                    ids_a.pop()
                else:
                    ids_b.pop()
        else:
            ids_a = ids_a[:budget]
        ids = [self.cls_token_id] + ids_a + [self.sep_token_id]
        types = [0] * len(ids)
        if ids_b:
            ids += ids_b + [self.sep_token_id]
            types += [1] * (len(ids_b) + 1)
        mask = [1] * len(ids)
        return ids, mask, types


def train_wordpiece_vocab(texts, vocab_size: int = 8000, do_lower_case: bool = True,
                          save_path: Optional[str] = None) -> WordPieceTokenizer:
    """Train a WordPiece vocab from raw texts via the `tokenizers` library.

    Offline replacement for hub-downloaded vocabs; used for custom corpora and
    for from-scratch training when no pretrained checkpoint is available.
    """
    from tokenizers import Tokenizer, models, normalizers, pre_tokenizers, trainers

    tok = Tokenizer(models.WordPiece(unk_token="[UNK]"))
    norm = [normalizers.NFD()]
    if do_lower_case:
        norm += [normalizers.Lowercase(), normalizers.StripAccents()]
    tok.normalizer = normalizers.Sequence(norm)
    tok.pre_tokenizer = pre_tokenizers.Sequence(
        [pre_tokenizers.Whitespace()]
    )
    trainer = trainers.WordPieceTrainer(
        vocab_size=vocab_size, special_tokens=SPECIAL_TOKENS,
        continuing_subword_prefix="##",
    )
    tok.train_from_iterator(texts, trainer)
    vocab = tok.get_vocab()
    # Re-index so special tokens take canonical low ids.
    items = sorted(vocab.items(), key=lambda kv: kv[1])
    ordered = SPECIAL_TOKENS + [t for t, _ in items if t not in SPECIAL_TOKENS]
    final = {t: i for i, t in enumerate(ordered)}
    wp = WordPieceTokenizer(final, do_lower_case)
    if save_path:
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        wp.save_vocab(save_path)
    return wp
