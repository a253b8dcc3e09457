"""Multi-process / multi-host execution (SURVEY §2.2's mapping of the
reference's thread-pool scale story, Mapper.java:943-1101).

Model: N processes (one per host, or N local processes) each align a
round-robin share of the query stream — query with global index i belongs to
process i % N, and keeps its global id so outputs are mergeable in exact
1-process order.  Each process on a GPU host takes one card of its own
(card_for_process).  `jax.distributed.initialize` links the processes for
barriers when a coordinator is given; result merging is:

- SAM: each process renders its results keyed by global query id into a
  shard file; after a cross-process barrier, process 0 interleaves the shards
  back into the serial emission order (byte-identical to 1-process).
- VCF/mutations: per-contig pileup arrays are pure sums — process 0 adds the
  other processes' arrays (exactly the psum fan-in, performed host-side at
  write time since the post-pass is host code); insertion events carry the
  global id of their first contributor so the example-read column matches the
  1-process run.
- refcounts / unaligned: same shard-merge by global id.
"""

from __future__ import annotations

import glob
import os
import pickle
import time

import numpy as np


def local_card_count(platforms: str | None = None) -> int:
    """NVIDIA cards on this host that JAX may use, counted without
    initializing JAX (initialization would reserve memory on every visible
    card).  0 when JAX is held to other platforms (`platforms` defaults to
    JAX's own setting)."""
    if platforms is None:
        import jax

        platforms = jax.config.jax_platforms or os.environ.get("JAX_PLATFORMS") or ""
    if platforms and not {"cuda", "gpu"} & set(platforms.split(",")):
        return 0
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible is not None:
        ids = [v.strip() for v in visible.split(",") if v.strip()]
        return 0 if "-1" in ids else len(ids)
    return len(glob.glob("/dev/nvidia[0-9]*"))


def card_for_process(
    process_id: int, num_processes: int, num_cards: int, single_host: bool = True
) -> int | None:
    """The card a process takes: process_id % num_cards, or None on a host
    without cards.  A JAX process reserves most of a card's memory, so two
    processes cannot share one: on a single host, more processes than cards
    is a usage error (ValueError)."""
    if num_cards <= 0:
        return None
    if single_host and num_processes > num_cards:
        raise ValueError(
            f"--num-processes {num_processes} needs one GPU per process; "
            f"this host has {num_cards}"
        )
    return process_id % num_cards


def bind_card(card: int | None) -> None:
    """Make `card` the only device this process's JAX sees (before any
    backend initialization)."""
    if card is None:
        return
    import jax

    jax.config.update("jax_cuda_visible_devices", str(card))


def initialize(
    coordinator: str, num_processes: int, process_id: int, card: int | None = None
) -> None:
    """jax.distributed.initialize wrapper (idempotent)."""
    import jax

    try:
        jax.distributed.initialize(
            coordinator,
            num_processes=num_processes,
            process_id=process_id,
            local_device_ids=None if card is None else [card],
        )
    except RuntimeError as e:  # already initialized
        if "already" not in str(e).lower():
            raise


def barrier(name: str) -> None:
    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices(name)


class RoundRobinQueries:
    """Wraps the global query iterator: yields only this process's share,
    with ids set to the GLOBAL stream index (1-based, matching the serial
    CLI numbering)."""

    def __init__(self, queries_iter, process_id: int, num_processes: int):
        self.queries_iter = queries_iter
        self.process_id = process_id
        self.num_processes = num_processes
        self.num_global = 0

    def __iter__(self):
        for i, qb in enumerate(self.queries_iter):
            self.num_global = i + 1
            if i % self.num_processes == self.process_id:
                qb.set_id(i + 1)
                yield qb


class ShardedResultWriter:
    """Listener capturing each result's rendered output keyed by global query
    id, for order-exact cross-process merging.  Wraps any row-stream writer
    (SamWriter, UnalignedQueryWriter-style) whose output is a function of the
    results fed to add_alignments."""

    def __init__(self, make_writer):
        """make_writer(stream) -> listener writing rows to `stream`."""
        self._chunks: list[str] = []
        self._sink = _ListStream(self._chunks)
        self.writer = make_writer(self._sink)
        self.header = "".join(self._chunks)  # whatever the ctor emitted
        del self._chunks[:]
        self.entries: list[tuple[int, str]] = []

    def add_alignments(self, results) -> None:
        for result in results:
            before = len(self._chunks)
            self.writer.add_alignments([result])
            text = "".join(self._chunks[before:])
            del self._chunks[before:]
            gid = result.query_sequences[0].identifier
            self.entries.append((gid, text))

    def save_shard(self, path: str) -> None:
        with open(path, "wb") as f:
            pickle.dump({"header": self.header, "entries": self.entries}, f)


class _ListStream:
    def __init__(self, chunks: list):
        self.chunks = chunks

    def write(self, text: str) -> None:
        self.chunks.append(text)

    def flush(self) -> None:
        pass


def merge_sam_shards(shard_paths: list[str], out_stream) -> None:
    """Interleave per-process shards back into global-id order."""
    all_entries: list[tuple[int, str]] = []
    header = None
    for path in shard_paths:
        with open(path, "rb") as f:
            data = pickle.load(f)
        if header is None:
            header = data["header"]
        all_entries.extend(data["entries"])
    all_entries.sort(key=lambda e: e[0])
    if header:
        out_stream.write(header)
    for _, text in all_entries:
        out_stream.write(text)


# --- pileup merging -------------------------------------------------------


def save_pileup_shard(match_database, path: str) -> None:
    """Serialize this process's accumulated pileups (post group_by_position)."""
    pileups = match_database.group_by_position()
    payload = {}
    for seq, pileup in pileups.items():
        payload[seq.name] = {
            "middle": pileup.middle,
            "end": pileup.end,
            "deletion_start_middle": pileup.deletion_start_middle,
            "insertions": dict(pileup.insertions),
        }
    with open(path, "wb") as f:
        pickle.dump(payload, f)


def merge_pileup_shards(match_database, shard_paths: list[str]) -> None:
    """Add other processes' pileup shards into this process's MatchDatabase.
    Array counts are pure sums; insertion events merge by (position, text)
    with the example read taken from the smallest first-contributor global id
    (reproducing the 1-process stream order)."""
    pileups = match_database.group_by_position()
    by_name = {seq.name: (seq, pileup) for seq, pileup in pileups.items()}
    for path in shard_paths:
        with open(path, "rb") as f:
            payload = pickle.load(f)
        for name, data in payload.items():
            if name not in by_name:
                # contig only covered by the other process: create its pileup
                seq = next(
                    s
                    for s in match_database._contig_sequences
                    if s.name == name
                )
                pileup = match_database._pileup_for(seq)
                by_name[name] = (seq, pileup)
            _, pileup = by_name[name]
            pileup.middle += data["middle"]
            pileup.end += data["end"]
            pileup.deletion_start_middle += data["deletion_start_middle"]
            for key, entry in data["insertions"].items():
                mine = pileup.insertions.get(key)
                if mine is None:
                    pileup.insertions[key] = list(entry)
                else:
                    mine[0] += entry[0]
                    mine[1] += entry[1]
                    their_gid = entry[3] if len(entry) > 3 else -1
                    my_gid = mine[3] if len(mine) > 3 else -1
                    if their_gid != -1 and (my_gid == -1 or their_gid < my_gid):
                        mine[2] = entry[2]
                        if len(mine) > 3:
                            mine[3] = their_gid


def wait_for_files(paths: list[str], timeout_s: float = 600.0) -> None:
    """File-presence barrier for runs without jax.distributed (each process
    touches `<path>.done` when finished)."""
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        if all(os.path.exists(p) for p in paths):
            return
        time.sleep(0.1)
    missing = [p for p in paths if not os.path.exists(p)]
    raise TimeoutError(f"timed out waiting for shards: {missing}")
