"""Harvest offline English prose for MLM pretraining.

Host copy of ``densephrases_tpu/preprocess/offline_corpus.py``: the port
never imports the JAX package, whose ``__init__`` imports jax. Keep the two
in step. Two deliberate differences: the reference checkout's files are
found under ``$DENSEPHRASES_REFERENCE_DIR`` (default ``reference``, beside
the working directory), and the docstring harvest locates the installed
packages with ``importlib.util.find_spec``, which runs none of them (the
reference imports each, jax among them).

No hub or network access exists in this environment, so the pretraining
corpus is assembled from every source of genuine English text already on
disk (role: the corpus the reference implicitly gets through pretrained
SpanBERT, ref: densephrases/encoder.py:20-52):

- the reference's bundled Wikipedia articles
  (examples/create-custom-index/articles.json, 112 paragraphs),
- its demo context examples (demo/static/examples_context.txt),
- English docstrings extracted (via ``ast``, no imports executed) from
  installed Python packages — numpy/scipy/torch/sklearn documentation is
  real prose at the megabyte scale,
- markdown/rst documents under explicitly passed roots.

Everything is filtered to prose-looking paragraphs (letters dominate,
sentence punctuation present, low symbol density) and deduped.
"""

from __future__ import annotations

import ast
import importlib.util
import json
import logging
import os
import re
from typing import Iterable, List, Optional

logger = logging.getLogger(__name__)

REF_ROOT = os.environ.get("DENSEPHRASES_REFERENCE_DIR", "reference")
REF_ARTICLES = os.path.join(REF_ROOT, "examples", "create-custom-index",
                            "articles.json")
REF_CONTEXTS = os.path.join(REF_ROOT, "densephrases", "demo", "static",
                            "examples_context.txt")
DOC_PACKAGES = ("numpy", "scipy", "torch", "sklearn", "pandas",
                "transformers", "jax", "flax", "optax", "matplotlib")

_WORD = re.compile(r"[A-Za-z]{2,}")
_CODEY = re.compile(r"[{}<>_=\\|]|::|->|>>>|\.\.\.")


def looks_like_prose(par: str, min_chars: int = 120) -> bool:
    """Keep paragraphs that read as English sentences, not code/tables."""
    par = par.strip()
    if len(par) < min_chars:
        return False
    letters = sum(c.isalpha() or c.isspace() for c in par)
    if letters / len(par) < 0.82:
        return False
    words = _WORD.findall(par)
    if len(words) < 15:
        return False
    if len(_CODEY.findall(par)) > 2:
        return False
    # needs sentence structure
    return par.count(". ") + par.count(".\n") + par.endswith(".") >= 2


def _normalize(par: str) -> str:
    return re.sub(r"\s+", " ", par).strip()


def paragraphs_from_articles(path: str = REF_ARTICLES) -> List[str]:
    data = json.load(open(path))["data"]
    return [_normalize(p["context"]) for a in data for p in a["paragraphs"]]


def paragraphs_from_contexts(path: str = REF_CONTEXTS) -> List[str]:
    """demo examples_context.txt: one paragraph per line, [header] lines
    between sections."""
    out = []
    for line in open(path, encoding="utf-8", errors="replace"):
        line = line.strip()
        if not line or (line.startswith("[") and line.endswith("]")):
            continue
        if looks_like_prose(line):
            out.append(_normalize(line))
    return out


def _docstrings_of_file(path: str) -> Iterable[str]:
    try:
        src = open(path, encoding="utf-8", errors="replace").read()
        tree = ast.parse(src)
    except (SyntaxError, ValueError, OSError, RecursionError):
        return
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            doc = ast.get_docstring(node, clean=True)
            if not doc:
                continue
            # split on blank lines; drop parameter tables / examples
            for par in re.split(r"\n\s*\n", doc):
                par = _normalize(par)
                if looks_like_prose(par):
                    yield par


def package_roots(names=DOC_PACKAGES) -> List[str]:
    """The source directories of the installed packages among ``names``,
    found without importing them."""
    roots = []
    for name in names:
        spec = importlib.util.find_spec(name)
        if spec is not None and spec.origin:
            roots.append(os.path.dirname(spec.origin))
    return roots


def paragraphs_from_docstrings(
        roots: Optional[List[str]] = None,
        max_files: int = 20000) -> List[str]:
    """Extract prose docstring paragraphs from installed packages. AST
    only — nothing is imported or executed."""
    if roots is None:
        roots = package_roots()
    out: List[str] = []
    n_files = 0
    for root in roots:
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = [d for d in dirnames
                           if d not in ("test", "tests", "__pycache__")]
            for fn in filenames:
                if not fn.endswith(".py"):
                    continue
                n_files += 1
                if n_files > max_files:
                    logger.warning("docstring harvest hit max_files=%d",
                                   max_files)
                    return out
                out.extend(_docstrings_of_file(os.path.join(dirpath, fn)))
    return out


def paragraphs_from_markdown(roots: List[str]) -> List[str]:
    out: List[str] = []
    for root in roots:
        for dirpath, _, filenames in os.walk(root):
            for fn in filenames:
                if not fn.endswith((".md", ".rst")):
                    continue
                try:
                    text = open(os.path.join(dirpath, fn), encoding="utf-8",
                                errors="replace").read()
                except OSError:
                    continue
                text = re.sub(r"```.*?```", " ", text, flags=re.S)
                for par in re.split(r"\n\s*\n", text):
                    par = _normalize(re.sub(r"[#*`]", "", par))
                    if looks_like_prose(par):
                        out.append(par)
    return out


def build_corpus(include_docstrings: bool = True,
                 md_roots: Optional[List[str]] = None,
                 out_path: Optional[str] = None) -> List[str]:
    """Assemble + dedupe the full offline corpus. Returns paragraphs;
    optionally writes one-paragraph-per-line to out_path (cached runs
    should read that file instead of re-walking site-packages)."""
    pars: List[str] = []
    pars.extend(paragraphs_from_articles())
    pars.extend(paragraphs_from_contexts())
    if include_docstrings:
        pars.extend(paragraphs_from_docstrings())
    if md_roots:
        pars.extend(paragraphs_from_markdown(md_roots))
    seen = set()
    uniq = []
    for p in pars:
        key = p.lower()[:160]
        if key in seen:
            continue
        seen.add(key)
        uniq.append(p)
    n_chars = sum(len(p) for p in uniq)
    logger.info("offline corpus: %d paragraphs, %.1f MB",
                len(uniq), n_chars / 1e6)
    if out_path:
        with open(out_path, "w", encoding="utf-8") as f:
            for p in uniq:
                f.write(p + "\n")
    return uniq


def load_corpus(path: str) -> List[str]:
    return [line.rstrip("\n") for line in open(path, encoding="utf-8")
            if line.strip()]


# ---------------------------------------------------------------- documents
# Structured variant: same harvest, but with DOCUMENT identity kept
# (article / context section / python source file / markdown file). The
# document key is what makes a genuinely open dev split possible: hold out
# whole documents, not question hashes (a question-hash split only tests
# unseen phrasings of seen passages).


def docs_from_articles(path: str = REF_ARTICLES) -> List[dict]:
    data = json.load(open(path))["data"]
    return [{"title": a["title"],
             "paragraphs": [_normalize(p["context"])
                            for p in a["paragraphs"]]}
            for a in data]


def docs_from_contexts(path: str = REF_CONTEXTS) -> List[dict]:
    """Each ``[header]`` section of examples_context.txt is one document."""
    docs: List[dict] = []
    title, pars = "demo-contexts", []
    for line in open(path, encoding="utf-8", errors="replace"):
        line = line.strip()
        if line.startswith("[") and line.endswith("]"):
            if pars:
                docs.append({"title": title, "paragraphs": pars})
            title, pars = line[1:-1], []
            continue
        if line and looks_like_prose(line):
            pars.append(_normalize(line))
    if pars:
        docs.append({"title": title, "paragraphs": pars})
    return docs


def docs_from_docstrings(roots: Optional[List[str]] = None,
                         max_files: int = 20000) -> List[dict]:
    """One document per python source file (AST only, nothing executed)."""
    if roots is None:
        roots = package_roots()
    docs: List[dict] = []
    n_files = 0
    for root in roots:
        base = os.path.basename(root.rstrip("/"))
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = [d for d in dirnames
                           if d not in ("test", "tests", "__pycache__")]
            for fn in sorted(filenames):
                if not fn.endswith(".py"):
                    continue
                n_files += 1
                if n_files > max_files:
                    logger.warning("docstring harvest hit max_files=%d",
                                   max_files)
                    return docs
                path = os.path.join(dirpath, fn)
                pars = list(_docstrings_of_file(path))
                if pars:
                    rel = os.path.relpath(path, os.path.dirname(root))
                    docs.append({"title": f"{base}:{rel}"
                                 if not rel.startswith(base) else rel,
                                 "paragraphs": pars})
    return docs


def build_corpus_docs(include_docstrings: bool = True,
                      md_roots: Optional[List[str]] = None,
                      out_path: Optional[str] = None) -> List[dict]:
    """Assemble the full offline corpus WITH document structure.

    Same sources, prose filter, and first-160-chars dedupe as
    ``build_corpus`` (a paragraph seen in an earlier document is dropped
    from later ones), so the flat paragraph set matches the MLM corpus.
    Returns [{'title', 'paragraphs'}]; optionally caches to JSON.
    """
    if out_path and os.path.exists(out_path):
        return json.load(open(out_path))
    groups: List[dict] = []
    groups.extend(docs_from_articles())
    groups.extend(docs_from_contexts())
    if include_docstrings:
        groups.extend(docs_from_docstrings())
    if md_roots:
        for root in md_roots:
            for dirpath, _, filenames in os.walk(root):
                for fn in sorted(filenames):
                    if not fn.endswith((".md", ".rst")):
                        continue
                    try:
                        text = open(os.path.join(dirpath, fn),
                                    encoding="utf-8",
                                    errors="replace").read()
                    except OSError:
                        continue
                    text = re.sub(r"```.*?```", " ", text, flags=re.S)
                    pars = [
                        _normalize(re.sub(r"[#*`]", "", p))
                        for p in re.split(r"\n\s*\n", text)]
                    pars = [p for p in pars if looks_like_prose(p)]
                    if pars:
                        groups.append({"title": fn, "paragraphs": pars})
    seen = set()
    docs: List[dict] = []
    for g in groups:
        pars = []
        for p in g["paragraphs"]:
            key = p.lower()[:160]
            if key in seen:
                continue
            seen.add(key)
            pars.append(p)
        if pars:
            docs.append({"title": g["title"], "paragraphs": pars})
    n_pars = sum(len(d["paragraphs"]) for d in docs)
    logger.info("offline corpus: %d documents / %d paragraphs",
                len(docs), n_pars)
    if out_path:
        with open(out_path, "w", encoding="utf-8") as f:
            json.dump(docs, f)
    return docs
