"""Config registry for all drivers.

Host copy of ``densephrases_tpu/options.py``: the port never imports the JAX
package, whose ``__init__`` imports jax. Keep the two in step.

TPU-native re-design of the reference's argparse ``Options`` groups
(ref: densephrases/options.py:15-251): here each group is a typed dataclass,
composable into an ``Options`` bundle; an argparse bridge auto-generates CLI
flags from the dataclass fields so the drivers keep a reference-compatible
command line. Env vars DATA_DIR / SAVE_DIR / CACHE_DIR remain the path-root
contract (ref: config.sh:27-34).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from dataclasses import dataclass, field, fields
from typing import List, Optional


def _env(name: str, default: str) -> str:
    return os.environ.get(name, default)


@dataclass
class ModelOptions:
    """Encoder/model group (ref: options.py:20-45)."""

    model_type: str = "bert"
    pretrained_name_or_path: str = "spanbert-base-cased"
    config_name: str = ""
    tokenizer_name: str = ""
    load_dir: str = ""
    output_dir: str = ""
    do_lower_case: bool = False
    max_seq_length: int = 384
    doc_stride: int = 128
    max_query_length: int = 64
    max_answer_length: int = 10
    # TPU-specific
    dtype: str = "bfloat16"
    use_flash_attention: bool = True


@dataclass
class IndexOptions:
    """Index build/serve group (ref: options.py:47-74)."""

    dump_dir: str = ""
    phrase_dir: str = "phrase"
    index_name: str = "start/1048576_flat_OPQ96"
    index_path: str = ""
    idx2id_path: str = ""
    num_clusters: int = 1048576
    fine_quant: str = "OPQ96"  # none / SQ8 / SQ4 / OPQ<m>[x4] / PQ<m>[x4]
    doc_sample_ratio: float = 0.2
    vec_sample_ratio: float = 0.2
    norm_th: float = 999.0
    # reference default is 256 (options.py ref) for its 1B-vector dumps;
    # at ~10M rows/chip the measured speed point is nprobe=16 (recall@20
    # ≥0.95, 2.3× faster than flat) and nprobe≥64 LOSES to the exact
    # flat scan — see docs/ARCHITECTURE.md §3 "Picking an operating
    # point" before raising this.
    nprobe: int = 256
    first_passage: bool = False
    index_filter: float = -1e8
    # Storage contract (ref: options.py:144-145)
    dense_offset: float = -2.0
    dense_scale: float = 20.0
    # TPU-specific: how many mesh shards the index is split over
    index_shards: int = 1


@dataclass
class DataOptions:
    """Data group (ref: options.py:76-146 data/rc subset)."""

    data_dir: str = field(default_factory=lambda: _env("DATA_DIR", "./data"))
    save_dir: str = field(default_factory=lambda: _env("SAVE_DIR", "./outputs"))
    cache_dir: str = field(default_factory=lambda: _env("CACHE_DIR", "./cache"))
    train_file: str = ""
    predict_file: str = ""
    dev_file: str = ""
    overwrite_cache: bool = False
    threads: int = 8
    append_title: bool = True


@dataclass
class TrainOptions:
    """RC training group (ref: options.py:87-146)."""

    per_device_train_batch_size: int = 12
    per_device_eval_batch_size: int = 12
    learning_rate: float = 3e-5
    gradient_accumulation_steps: int = 1
    weight_decay: float = 0.01
    adam_epsilon: float = 1e-8
    max_grad_norm: float = 1.0
    num_train_epochs: float = 2.0
    max_steps: int = -1
    warmup_steps: int = 0
    seed: int = 42
    logging_steps: int = 5000
    save_steps: int = 9999999999
    # Loss weights (ref: options.py lambda flags; encoder.py:262-355)
    lambda_kl: float = 0.0
    lambda_neg: float = 0.0
    lambda_flt: float = 0.0
    pbn_size: int = 0  # pre-batch negative queue length
    pbn_tolerance_epoch: int = 0
    filter_threshold: float = -2.0
    teacher_dir: str = ""
    wandb: bool = False
    # backward-pass rematerialization: full | dots | none (models/bert.py)
    remat: str = "full"
    # FFN activation override: "" keeps the loaded config's activation
    # (exact erf gelu for HF-imported checkpoints); "gelu_tanh" trains
    # with the tanh approximation (+5 MFU points, docs/TRAIN_ABLATE.json)
    hidden_act: str = ""
    # In the port this option has no effect: its dropout seeds come from a
    # torch.Generator seeded with --seed. The values stay accepted so that
    # the reference's command lines parse unchanged.
    # PRNG for dropout masks: "threefry" (the JAX default threefry2x32;
    # pure-VPU bit generation costs ~26 ms/step at b24/L384) | "rbg"
    # (hardware-backed RngBitGenerator — the TPU training default; dropout
    # masks do not need counter-based reproducibility across reshards).
    # Normalized by _sanity_check: jax.random.key only accepts the full
    # name "threefry2x32".
    rng_impl: str = "rbg"


@dataclass
class RetrievalOptions:
    """Open-domain retrieval group (ref: options.py:148-174)."""

    test_path: str = ""
    candidate_path: str = ""
    regex: bool = False
    eval_batch_size: int = 10
    psg_top_k: int = 100
    top_k: int = 10
    return_sent: bool = False
    truecase: bool = True
    truecase_path: str = ""
    agg_strat: str = "opt1"
    kilt: bool = False
    title2wikiid_path: str = ""
    eval_psg: bool = False  # passage-level eval (ref: eval_psg mode)
    save_pred: bool = True
    # index residency: device (HBM) | host (memmap'd store + inverted
    # lists, the OnDiskInvertedLists serving mode for corpora > HBM)
    index_tier: str = "device"


@dataclass
class QsftOptions:
    """Query-side fine-tuning group (ref: options.py:177-187)."""

    qsft_learning_rate: float = 3e-5
    qsft_epochs: int = 3
    qsft_top_k: int = 100
    label_strat: str = "phrase"  # phrase | doc | phrase,doc
    update_freq: int = 1


@dataclass
class DemoOptions:
    """Serving group (ref: options.py:189-193)."""

    query_port: int = 10001
    index_port: int = 10002
    demo_mode: str = "serve_query"


@dataclass
class Options:
    """Composable bundle of all option groups (ref: options.py:15-251).

    Drivers compose the groups they need, e.g.
    ``Options().parse()`` from CLI or ``Options(model=ModelOptions(...))``
    programmatically.
    """

    model: ModelOptions = field(default_factory=ModelOptions)
    index: IndexOptions = field(default_factory=IndexOptions)
    data: DataOptions = field(default_factory=DataOptions)
    train: TrainOptions = field(default_factory=TrainOptions)
    retrieval: RetrievalOptions = field(default_factory=RetrievalOptions)
    qsft: QsftOptions = field(default_factory=QsftOptions)
    demo: DemoOptions = field(default_factory=DemoOptions)
    draft: bool = False  # tiny-sample smoke mode (ref: options.py:196-198)
    verbose: bool = False

    GROUPS = ("model", "index", "data", "train", "retrieval", "qsft", "demo")

    def add_to_parser(self, parser: argparse.ArgumentParser, groups: Optional[List[str]] = None):
        groups = groups or list(self.GROUPS)
        for group_name in groups:
            group_obj = getattr(self, group_name)
            ap_group = parser.add_argument_group(group_name)
            for f in fields(group_obj):
                flag = "--" + f.name
                default = getattr(group_obj, f.name)
                if f.type in ("bool", bool) or isinstance(default, bool):
                    ap_group.add_argument(
                        flag, action="store_true", default=default
                    )
                else:
                    ap_group.add_argument(flag, type=type(default), default=default)
        parser.add_argument("--draft", action="store_true", default=self.draft)
        parser.add_argument("--verbose", action="store_true", default=self.verbose)
        return parser

    def parse(self, args=None, groups: Optional[List[str]] = None) -> "Options":
        parser = argparse.ArgumentParser()
        self.add_to_parser(parser, groups)
        ns, _ = parser.parse_known_args(args)
        groups = groups or list(self.GROUPS)
        for group_name in groups:
            group_obj = getattr(self, group_name)
            for f in fields(group_obj):
                if hasattr(ns, f.name):
                    setattr(group_obj, f.name, getattr(ns, f.name))
        self.draft = ns.draft
        self.verbose = ns.verbose
        self._sanity_check()
        return self

    def _sanity_check(self):
        # ref: options.py:226-251 parse-time validations
        assert self.model.max_answer_length >= 1
        if self.index.fine_quant not in ("none", "SQ8", "SQ4"):
            from densephrases_tpu_torch.index.ivf import parse_pq_quant

            # PQ/OPQ specs: "OPQ96" (8-bit, reference parity) or
            # "OPQ192x4" (4-bit fast-scan; same bytes, 16-wide one-hot)
            assert parse_pq_quant(self.index.fine_quant) is not None, (
                f"unknown fine_quant {self.index.fine_quant}"
            )
        # jax.random.key's spelling of the default PRNG is "threefry2x32";
        # accept the documented short form here so --rng_impl threefry works
        if self.train.rng_impl == "threefry":
            self.train.rng_impl = "threefry2x32"
        assert self.train.rng_impl in ("rbg", "threefry2x32", "unsafe_rbg"), (
            f"unknown rng_impl {self.train.rng_impl}"
        )
        if self.draft:
            self.train.logging_steps = 999999999

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)
