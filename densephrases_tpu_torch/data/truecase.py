"""N-gram-statistics truecaser.

Host copy of ``densephrases_tpu/data/truecase.py``: the port never imports the JAX
package, whose ``__init__`` imports jax. Keep the two in step.

Open-domain questions arrive lowercased; the encoder was trained on cased
text, so queries are truecased before encoding (ref: TrueCaser,
squad_utils.py:1452-1589, used at model.py:66-67 and open_utils.py:117).

Same statistical method: pick each word's casing by unigram frequency with
bigram/trigram context backoff, learned from a cased corpus. The distribution
file is a pickle of {uni, bi, tri} counters; ``TrueCaser.train`` can build one
from any cased text corpus (the reference ships a pre-built pickle)."""

from __future__ import annotations

import pickle
import re
from collections import defaultdict
from typing import Dict, List, Optional

_TOKEN_RE = re.compile(r"\w+|[^\w\s]", re.UNICODE)


def _tokenize(text: str) -> List[str]:
    return _TOKEN_RE.findall(text)


class TrueCaser:
    def __init__(self, dist_path: Optional[str] = None):
        self.uni: Dict[str, Dict[str, int]] = defaultdict(dict)
        self.bi: Dict[str, Dict[str, int]] = defaultdict(dict)
        self.tri: Dict[str, Dict[str, int]] = defaultdict(dict)
        if dist_path:
            with open(dist_path, "rb") as f:
                obj = pickle.load(f)
            self.uni, self.bi, self.tri = (
                defaultdict(dict, obj["uni"]), defaultdict(dict, obj["bi"]),
                defaultdict(dict, obj["tri"]))

    # ---------------- training ----------------
    def train(self, sentences):
        for sent in sentences:
            toks = _tokenize(sent)
            low = [t.lower() for t in toks]
            for i, (t, lw) in enumerate(zip(toks, low)):
                if i == 0:
                    continue  # sentence-initial casing is uninformative
                self.uni[lw][t] = self.uni[lw].get(t, 0) + 1
                if i + 1 < len(toks):
                    key = f"{lw}_{low[i+1]}"
                    self.bi[key][t] = self.bi[key].get(t, 0) + 1
                if 0 < i and i + 1 < len(toks):
                    key = f"{low[i-1]}_{lw}_{low[i+1]}"
                    self.tri[key][t] = self.tri[key].get(t, 0) + 1

    def save(self, path: str):
        with open(path, "wb") as f:
            pickle.dump({"uni": dict(self.uni), "bi": dict(self.bi),
                         "tri": dict(self.tri)}, f)

    # ---------------- inference ----------------
    def _best(self, table: Dict[str, int]) -> Optional[str]:
        if not table:
            return None
        return max(table.items(), key=lambda kv: kv[1])[0]

    def get_true_case(self, text: str, out_of_vocab: str = "title") -> str:
        toks = _tokenize(text)
        low = [t.lower() for t in toks]
        out = []
        for i, lw in enumerate(low):
            cased = None
            if 0 < i and i + 1 < len(low):
                cased = self._best(self.tri.get(f"{low[i-1]}_{lw}_{low[i+1]}", {}))
            if cased is None and i + 1 < len(low):
                cased = self._best(self.bi.get(f"{lw}_{low[i+1]}", {}))
            if cased is None:
                cased = self._best(self.uni.get(lw, {}))
            if cased is None:  # OOV policy (ref: squad_utils.py:1560-1575)
                if out_of_vocab == "title" and i == 0:
                    cased = lw.capitalize()
                elif out_of_vocab == "lower":
                    cased = lw
                else:
                    cased = lw.capitalize() if i == 0 else lw
            out.append(cased)
        # re-join with original spacing approximation
        text_out = ""
        for i, tok in enumerate(out):
            if i > 0 and re.match(r"\w", tok):
                text_out += " "
            text_out += tok
        return text_out
