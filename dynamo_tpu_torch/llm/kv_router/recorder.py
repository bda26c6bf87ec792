"""JSONL event recording + replay, a copy of
dynamo_tpu/llm/kv_router/recorder.py (reference: lib/llm/src/recorder.rs:37,
kv_router/recorder.rs) — capture live RouterEvents for offline router
reconstruction and workload studies."""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Iterator

from dynamo_tpu_torch.llm.kv_router.indexer import KvIndexer, RadixTree
from dynamo_tpu_torch.llm.kv_router.protocols import KvCacheEvent, RouterEvent


class KvRecorder:
    def __init__(self, path: str | Path):
        self.path = Path(path)
        self._fh = open(self.path, "a", encoding="utf-8")
        self.count = 0

    def record(self, event: RouterEvent) -> None:
        entry = {
            "ts": time.time(),
            "worker_id": event.worker_id,
            "event": {
                "kind": event.event.kind,
                "block_hashes": event.event.block_hashes,
                "parent_hash": event.event.parent_hash,
                "token_count": event.event.token_count,
            },
        }
        self._fh.write(json.dumps(entry) + "\n")
        self.count += 1

    def flush(self) -> None:
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()


def iter_events(path: str | Path) -> Iterator[tuple[float, RouterEvent]]:
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            yield d["ts"], RouterEvent(worker_id=d["worker_id"], event=KvCacheEvent(**d["event"]))


def replay_into_tree(path: str | Path) -> RadixTree:
    """Rebuild the radix index offline from a recording."""
    tree = RadixTree()
    for _, event in iter_events(path):
        tree.apply(event)
    return tree


async def replay_into_indexer(path: str | Path, indexer: KvIndexer) -> int:
    n = 0
    for _, event in iter_events(path):
        indexer.push(event)
        n += 1
    return n
