"""SQLite document store for preprocessing.

Host copy of ``densephrases_tpu/preprocess/doc_db.py``: the port never imports the JAX
package, whose ``__init__`` imports jax. Keep the two in step.

Parity with ref: scripts/preprocess/build_db.py (143 LoC) +
scripts/preprocess/doc_db.py: store (id, title, text) rows from extracted
Wikipedia (or any corpus) into sqlite for random access during corpus
construction. Kept sqlite-backed like the reference — this is offline
host-side tooling, not a TPU path.
"""

from __future__ import annotations

import json
import os
import sqlite3
from typing import Iterable, List, Optional, Tuple


class DocDB:
    """Read/write wrapper over the documents table."""

    def __init__(self, db_path: str):
        self.path = db_path
        self.conn = sqlite3.connect(db_path)

    def close(self):
        self.conn.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    # ---------------- write ----------------
    def create(self):
        self.conn.execute(
            "CREATE TABLE IF NOT EXISTS documents "
            "(id TEXT PRIMARY KEY, title TEXT, text TEXT);")
        self.conn.commit()

    def insert_many(self, rows: Iterable[Tuple[str, str, str]]):
        self.conn.executemany(
            "INSERT OR REPLACE INTO documents VALUES (?,?,?)", rows)
        self.conn.commit()

    # ---------------- read ----------------
    def doc_ids(self) -> List[str]:
        cur = self.conn.execute("SELECT id FROM documents")
        return [r[0] for r in cur.fetchall()]

    def get_doc_text(self, doc_id: str) -> Optional[str]:
        cur = self.conn.execute(
            "SELECT text FROM documents WHERE id = ?", (doc_id,))
        row = cur.fetchone()
        return row[0] if row else None

    def get_doc_title(self, doc_id: str) -> Optional[str]:
        cur = self.conn.execute(
            "SELECT title FROM documents WHERE id = ?", (doc_id,))
        row = cur.fetchone()
        return row[0] if row else None


def build_db(db_path: str, input_dir: str) -> int:
    """Build a DocDB from WikiExtractor-style jsonl files (one json per line
    with 'id', 'title'/'url', 'text') (ref: build_db.py main flow)."""
    with DocDB(db_path) as db:
        db.create()
        count = 0
        batch: List[Tuple[str, str, str]] = []
        for root, _dirs, files in os.walk(input_dir):
            for name in sorted(files):
                path = os.path.join(root, name)
                with open(path, encoding="utf-8") as f:
                    for line in f:
                        if not line.strip():
                            continue
                        row = json.loads(line)
                        batch.append((str(row["id"]),
                                      row.get("title", row.get("url", "")),
                                      row["text"]))
                        count += 1
                        if len(batch) >= 1000:
                            db.insert_many(batch)
                            batch = []
        if batch:
            db.insert_many(batch)
    return count
