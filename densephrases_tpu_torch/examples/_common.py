"""Shared fixture builder for the runnable examples.

The counterpart of ``examples/_common.py``. Every example drives the real
pipeline end to end (a vocab, the phrase dump, ``MIPS``, the task's eval)
on a tiny corpus with a tiny encoder made from scratch, so it runs offline
in about a minute; with trained weights (``--load_dir``) the same code
paths give the reference tasks' quality.
"""

from __future__ import annotations

import os
import tempfile

from densephrases_tpu_torch.data.tokenization import VOCAB_KINDS

# A small entity-centric corpus: each doc is a KILT-style wiki page.
TINY_WIKI = [
    {"title": "Marie Curie",
     "text": "Marie Curie was a physicist and chemist. Marie Curie "
             "discovered the elements polonium and radium. Marie Curie "
             "was born in Warsaw and won the Nobel Prize twice."},
    {"title": "Albert Einstein",
     "text": "Albert Einstein was a theoretical physicist. Albert Einstein "
             "developed the theory of relativity. Albert Einstein was born "
             "in Ulm and won the Nobel Prize in 1921."},
    {"title": "Ada Lovelace",
     "text": "Ada Lovelace was a mathematician. Ada Lovelace wrote the "
             "first computer program. Ada Lovelace worked with Charles "
             "Babbage on the Analytical Engine in London."},
    {"title": "Alan Turing",
     "text": "Alan Turing was a computer scientist. Alan Turing created "
             "the Turing machine and broke the Enigma code. Alan Turing "
             "was born in London."},
    {"title": "Rosalind Franklin",
     "text": "Rosalind Franklin was a chemist. Rosalind Franklin captured "
             "the X-ray image of DNA known as Photo 51. Rosalind Franklin "
             "worked at King's College London."},
]


def default_workdir(name: str) -> str:
    """An example's default working directory, in the system's temp dir."""
    return os.path.join(tempfile.gettempdir(), name)


def add_vocab_arg(ap):
    """``--vocab_kind``: the from-scratch encoder's vocab, trained WordPiece
    (needs `tokenizers`, as the reference does) or whole words (needs
    nothing)."""
    ap.add_argument("--vocab_kind", choices=VOCAB_KINDS, default="wordpiece")


def parse_device(argv, device):
    """(argv without ``--cpu``, device): ``--cpu`` asks for the CPU, as the
    reference's examples take it."""
    argv = list(argv)
    if "--cpu" in argv:
        argv.remove("--cpu")
        device = "cpu"
    return argv, device


def build_tiny_model(workdir: str, load_dir: str = "", *, device="cuda",
                     vocab_kind: str = "wordpiece"):
    """Train-or-load an encoder, dump TINY_WIKI, return (dp, store)."""
    import torch

    from densephrases_tpu_torch import DensePhrases, MIPS
    from densephrases_tpu_torch.data.tokenization import build_vocab
    from densephrases_tpu_torch.dump import dump_phrases
    from densephrases_tpu_torch.models.bert import BertConfig
    from densephrases_tpu_torch.models.encoder import init_encoder_params

    docs = [{"doc_id": i, "title": d["title"], "paragraphs": [d["text"]]}
            for i, d in enumerate(TINY_WIKI)]
    if load_dir:
        from densephrases_tpu_torch.cli.common import load_encoder

        params, config, tokenizer = load_encoder(load_dir, device=device)
    else:
        tokenizer = build_vocab([d["text"] for d in TINY_WIKI],
                                vocab_size=1200, kind=vocab_kind)
        config = BertConfig.tiny(vocab_size=tokenizer.vocab_size)
        params = init_encoder_params(config, torch.Generator().manual_seed(0),
                                     device=device)
    store = dump_phrases(params, config, tokenizer, docs,
                         os.path.join(workdir, "store"), max_seq_length=128,
                         batch_size=4)
    dp = DensePhrases(params, config, tokenizer,
                      MIPS(store, device=params.device), max_query_length=32)
    return dp, store
