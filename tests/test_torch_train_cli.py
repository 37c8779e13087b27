"""Port's RC training driver (``densephrases_tpu_torch.cli.train_rc.main``)
end to end on the CPU at a tiny size, and the host copies it runs on
(``options.py``, ``data/qa.py``, ``data/rc_dataset.py``) against the
reference's."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from densephrases_tpu.data.rc_dataset import batches as jax_batches
from densephrases_tpu.data.rc_dataset import convert_rc_examples as jax_convert
from densephrases_tpu.data.tokenization import WordPieceTokenizer as JaxTokenizer
from densephrases_tpu.options import Options as JaxOptions
from densephrases_tpu_torch.cli import train_rc
from densephrases_tpu_torch.cli.common import load_encoder, save_encoder
from densephrases_tpu_torch.data.qa import load_rc_examples
from densephrases_tpu_torch.data.rc_dataset import batches, convert_rc_examples
from densephrases_tpu_torch.data.tokenization import (
    SPECIAL_TOKENS,
    WordPieceTokenizer,
)
from densephrases_tpu_torch.models.bert import BertConfig
from densephrases_tpu_torch.models.encoder import TEACHER, init_encoder_params
from densephrases_tpu_torch.options import Options

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = [f"w{i}" for i in range(200)]
VOCAB = {t: i for i, t in enumerate(SPECIAL_TOKENS + WORDS + [".", ","])}


def _squad(path, seed=0, n_titles=4):
    """A SQuAD-format file: each question is words of its paragraph, each
    answer a 1-5 word span of it."""
    rng = np.random.default_rng(seed)
    data = []
    for a in range(n_titles):
        paras = []
        for p in range(2):
            ws = list(rng.choice(WORDS, 40))
            qas = []
            for q in range(3):
                s, n = int(rng.integers(0, 35)), int(rng.integers(1, 6))
                start = len(" ".join(ws[:s])) + (1 if s else 0)
                qas.append({"id": f"{a}-{p}-{q}",
                            "question": " ".join(rng.choice(ws, 6)),
                            "answers": [{"text": " ".join(ws[s:s + n]),
                                         "answer_start": start}]})
            paras.append({"context": " ".join(ws), "qas": qas})
        data.append({"title": f"t{a}", "paragraphs": paras})
    with open(path, "w") as f:
        json.dump({"data": data}, f)
    return path


# every loss part and the teacher; --draft turns the logging_steps cadence
# off (options.py), --verbose logs every step
ARGS = ["--lambda_neg", "2.0", "--lambda_flt", "1.0", "--lambda_kl", "2.0",
        "--pbn_size", "2", "--per_device_train_batch_size", "4",
        "--max_seq_length", "64", "--max_query_length", "16",
        "--doc_stride", "32", "--warmup_steps", "1", "--max_steps", "3",
        "--save_steps", "2", "--draft", "--verbose"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_rc")
    train = _squad(str(tmp / "train.json"))
    cfg = BertConfig.tiny(vocab_size=len(VOCAB))
    save_encoder(str(tmp / "init"), init_encoder_params(cfg, device="cpu"), cfg,
                 WordPieceTokenizer(VOCAB))
    out = str(tmp / "out")
    state, rates = train_rc.main(
        ["--load_dir", str(tmp / "init"), "--train_file", train,
         "--dev_file", train, "--output_dir", out] + ARGS, device="cpu")
    return {"tmp": tmp, "out": out, "state": state, "rates": rates,
            "cfg": cfg, "train": train}


def test_every_step_logs_a_finite_loss_with_every_part(run):
    with open(os.path.join(run["out"], "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows] == [1, 2, 3]
    for r in rows:
        for k in ("loss", "single_loss", "neg_loss", "filter_loss", "kl_loss"):
            assert np.isfinite(r[k]), (k, r)
    assert run["state"].step == 3
    assert run["state"].pre_batch["count"] == 3


def test_saves_encoder_and_checkpoints(run):
    out = run["out"]
    for name in ("config.json", "vocab.txt", "params/step_0/state.pt",
                 "ckpt/step_2/state.pt", "ckpt/step_3/state.pt",
                 "eval_logger.txt"):
        assert os.path.exists(os.path.join(out, name)), name


def test_reload_gives_the_trained_student_without_teacher(run):
    params, cfg, tok = load_encoder(run["out"], device="cpu")
    assert cfg == run["cfg"] and tok.vocab == VOCAB
    assert not params.with_teacher
    trained = run["state"].params.state_dict()
    loaded = params.state_dict()
    assert set(trained) - set(loaded) == {
        k for k in trained if k.split(".")[0] in TEACHER}
    for k, v in loaded.items():
        assert torch.equal(v, trained[k]), k


def test_eval_and_filter_outputs(run):
    with open(os.path.join(run["out"], "eval_logger.txt")) as f:
        line = f.read().strip().splitlines()[-1]
    fields = dict(x.split("=") for x in line.split("\t")[1:])
    assert line.startswith("rc-dev") and fields["step"] == "3"
    assert 0.0 <= float(fields["EM"]) <= float(fields["F1"]) <= 100.0
    rates = run["rates"]
    assert list(rates) == [-4, -3, -2, -1, 0, 1, 2]
    vals = list(rates.values())
    assert all(0.0 <= r <= 1.0 for r in vals)
    assert vals == sorted(vals, reverse=True)  # a higher threshold keeps less


def test_cuda_device_is_never_replaced_by_the_cpu(run):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        train_rc.main(["--train_file", run["train"]] + ARGS)


def test_rc_features_match_reference(run):
    examples = load_rc_examples(run["train"])
    kw = dict(max_seq_length=64, doc_stride=32, max_query_length=16,
              with_teacher=True, max_cross_length=80)
    got = convert_rc_examples(examples, WordPieceTokenizer(VOCAB), **kw)
    want = jax_convert(examples, JaxTokenizer(VOCAB), **kw)
    assert len(got) == len(want) == 24
    for g, w in zip(batches(got, 4, seed=3), jax_batches(want, 4, seed=3)):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_options_parse_like_reference():
    argv = ["--train_file", "x.json", "--lambda_neg", "2.0", "--remat", "none",
            "--rng_impl", "threefry", "--fine_quant", "OPQ96", "--draft"]
    got = Options().parse(argv).to_dict()
    want = JaxOptions().parse(argv).to_dict()
    assert got == want
    with pytest.raises(AssertionError, match="fine_quant"):
        Options().parse(["--fine_quant", "XYZ"])


def test_training_modules_import_without_jax(tmp_path):
    code = ("import sys\n"
            "import densephrases_tpu_torch\n"
            "import densephrases_tpu_torch.cli.train_rc\n"
            "import densephrases_tpu_torch.cli.common\n"
            "import densephrases_tpu_torch.train.rc\n"
            "import densephrases_tpu_torch.train.cross_encoder\n"
            "import densephrases_tpu_torch.eval.rc\n"
            "import densephrases_tpu_torch.utils.checkpoint\n"
            "import densephrases_tpu_torch.utils.metrics_log\n"
            "import densephrases_tpu_torch.tools.profile_train\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', "
            "'densephrases_tpu.')) or m in ('densephrases_tpu', 'wandb')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
