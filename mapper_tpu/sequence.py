"""Sequence model: immutable 4-bit-encoded sequences and the sequence database.

Mirrors the reference's QuickVariants `Sequence`, `SequenceBuilder` and
`SequenceDatabase` classes (API reconstructed in SURVEY.md §2.3; usage sites e.g.
/root/reference/src/main/java/mapper/Mapper.java:1151-1172 for the
sort-and-add-reverse-complements convention and PackedMap.java:124-171 for the
position codec).

Batch-first notes: a Sequence wraps a numpy uint8 array of 4-bit codes — the exact
bytes the device kernels consume. The SequenceDatabase assigns every sequence
(forward and reverse-complement) a contiguous range in one global coordinate
space so a (sequence, offset) position packs into a single int64; the packed
index tables and the device-side gather work entirely in these global
coordinates.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable

import numpy as np

from mapper_tpu import basepairs


class Sequence:
    """An immutable named sequence of 4-bit-encoded basepairs."""

    __slots__ = (
        "name",
        "codes",
        "path",
        "quality",
        "complemented_from",
        "identifier",
        "_rc_cache",
        "_codes_bytes",
    )

    def __init__(
        self,
        name: str,
        codes: np.ndarray,
        path: str | None = None,
        quality: bytes | None = None,
        complemented_from: "Sequence | None" = None,
        identifier: int = -1,
    ):
        self.name = name
        self.codes = np.ascontiguousarray(codes, dtype=np.uint8)
        self.codes.setflags(write=False)
        self.path = path
        self.quality = quality
        self.complemented_from = complemented_from
        self.identifier = identifier
        self._rc_cache: "Sequence | None" = None
        self._codes_bytes: bytes | None = None

    @property
    def codes_bytes(self) -> bytes:
        """The codes as an immutable bytes object (cached) — Python-int
        indexing into bytes is ~3x faster than numpy scalar extraction, which
        matters in the sequential walk's per-base sampling loops."""
        b = self._codes_bytes
        if b is None:
            b = self.codes.tobytes()
            self._codes_bytes = b
        return b

    @staticmethod
    def from_text(name: str, text: str, path: str | None = None) -> "Sequence":
        return Sequence(name, basepairs.encode(text), path=path)

    def __len__(self) -> int:
        return int(self.codes.shape[0])

    @property
    def length(self) -> int:
        return int(self.codes.shape[0])

    def get_text(self) -> str:
        return basepairs.decode(self.codes)

    def get_range(self, start: int, length: int) -> str:
        return basepairs.decode(self.codes[start : start + length])

    def encoded_char_at(self, index: int) -> int:
        return int(self.codes[index])

    def char_at(self, index: int) -> str:
        return basepairs.decode_one(int(self.codes[index]))

    def reverse_complement(self) -> "Sequence":
        """Returns the reverse complement; its `complemented_from` is this
        sequence.  The RC of an RC is the original object — pair-orientation
        checks rely on `complemented_from` distinguishing strands, so a double
        reverse-complement must not look reversed (pinned by the reference's
        AlignerWorker_Test.doTestPairedEndQueries: same-orientation mates must
        not pair)."""
        if self.complemented_from is not None:
            return self.complemented_from
        if self._rc_cache is None:
            self._rc_cache = Sequence(
                self.name + "-rev",
                basepairs.reverse_complement(self.codes),
                path=self.path,
                quality=None if self.quality is None else self.quality[::-1],
                complemented_from=self,
                identifier=self.identifier,
            )
        return self._rc_cache

    def get_subsequence(self, start: int, length: int, name: str | None = None) -> "Sequence":
        sub = Sequence(
            name if name is not None else f"{self.name}_{start}",
            self.codes[start : start + length],
            path=self.path,
            quality=None if self.quality is None else self.quality[start : start + length],
        )
        return sub

    def __repr__(self) -> str:
        return f"Sequence({self.name!r}, len={len(self)})"


class SequenceBuilder:
    """Accumulates text and metadata, then builds a Sequence."""

    def __init__(self):
        self._name: str = ""
        self._path: str | None = None
        self._chunks: list[str] = []
        self._length = 0
        self._quality: list[bytes] = []
        self._id: int = -1

    def set_name(self, name: str) -> "SequenceBuilder":
        self._name = name
        return self

    def get_name(self) -> str:
        return self._name

    def set_path(self, path: str | None) -> "SequenceBuilder":
        self._path = path
        return self

    def set_id(self, identifier: int) -> "SequenceBuilder":
        self._id = identifier
        return self

    def add(self, text: str) -> "SequenceBuilder":
        self._chunks.append(text)
        self._length += len(text)
        return self

    def add_quality(self, quality: bytes | str) -> "SequenceBuilder":
        if isinstance(quality, str):
            quality = quality.encode("ascii")
        self._quality.append(quality)
        return self

    def get_length(self) -> int:
        return self._length

    def build(self) -> Sequence:
        text = "".join(self._chunks)
        quality = b"".join(self._quality) if self._quality else None
        return Sequence(
            self._name,
            basepairs.encode(text),
            path=self._path,
            quality=quality,
            identifier=self._id,
        )


def sort_and_complement(sequences: Iterable[Sequence]) -> list[Sequence]:
    """Order contigs by descending length (stable) and interleave each with its
    reverse complement, matching Mapper.sortAndComplementReference
    (Mapper.java:1151-1172): the Java TreeMap<length*-1, list> keeps insertion
    order within one length, and each sequence is immediately followed by its RC.
    """
    by_length: dict[int, list[Sequence]] = {}
    for seq in sequences:
        bucket = by_length.setdefault(-len(seq), [])
        bucket.append(seq)
        bucket.append(seq.reverse_complement())
    out: list[Sequence] = []
    for key in sorted(by_length):
        out.extend(by_length[key])
    return out


@dataclass
class SequenceDatabase:
    """A container of forward + reverse-complement sequences with a global
    position codec.

    Every sequence gets a global start offset; a (sequence, index) position is
    encoded as the int64 `start + index`. This keeps positions sortable in a
    canonical order (the deterministic "pack" order of the index; reference
    PackedMap.pack / ByteKeyStore ordering) and makes them directly usable as
    gather indices into a single concatenated reference array on device.
    """

    sequences: list[Sequence] = field(default_factory=list)
    starts: np.ndarray = field(default_factory=lambda: np.zeros(0, dtype=np.int64))
    total_size: int = 0

    def __init__(self, sequences: Iterable[Sequence] | Sequence, add_reverse_complements: bool = False):
        if isinstance(sequences, Sequence):
            sequences = [sequences]
        seqs = list(sequences)
        if add_reverse_complements:
            expanded = []
            for seq in seqs:
                expanded.append(seq)
                expanded.append(seq.reverse_complement())
            seqs = expanded
        self.sequences = seqs
        starts = np.zeros(len(seqs) + 1, dtype=np.int64)
        for i, seq in enumerate(seqs):
            starts[i + 1] = starts[i] + len(seq)
        self.starts = starts
        self.total_size = int(starts[-1])
        self._index_by_id = {id(seq): i for i, seq in enumerate(seqs)}
        # map forward sequence -> its reverse complement and vice versa
        self._rc_index: dict[int, int] = {}
        by_identity: dict[int, int] = {id(s): i for i, s in enumerate(seqs)}
        for i, seq in enumerate(seqs):
            if seq.complemented_from is not None and id(seq.complemented_from) in by_identity:
                j = by_identity[id(seq.complemented_from)]
                self._rc_index[i] = j
                self._rc_index[j] = i
        # any forward sequence without a registered RC gets one lazily
        self._concatenated: np.ndarray | None = None

    # --- basic accessors -------------------------------------------------

    def get_all(self) -> list[Sequence]:
        return self.sequences

    def get_forward_sequences_only(self) -> list[Sequence]:
        return [s for s in self.sequences if s.complemented_from is None]

    def get_num_sequences(self) -> int:
        return len(self.sequences)

    def get_sequence(self, i: int) -> Sequence:
        return self.sequences[i]

    def index_of(self, sequence: Sequence) -> int:
        return self._index_by_id[id(sequence)]

    def index_of_or_none(self, sequence: Sequence) -> int | None:
        """Like index_of but None for sequences this database doesn't hold
        (the reference's HashMap.get-returning-null contract)."""
        return self._index_by_id.get(id(sequence))

    def get_total_forward_size(self) -> int:
        return sum(len(s) for s in self.get_forward_sequences_only())

    def get_total_forward_and_reverse_size(self) -> int:
        return self.total_size

    def get_duplicate_names(self) -> list[str]:
        seen: set[str] = set()
        duplicates: list[str] = []
        for seq in self.get_forward_sequences_only():
            if seq.name in seen:
                duplicates.append(seq.name)
            seen.add(seq.name)
        return duplicates

    def get_reverse_complement(self, sequence: Sequence) -> Sequence:
        i = self._index_by_id.get(id(sequence))
        if i is not None and i in self._rc_index:
            return self.sequences[self._rc_index[i]]
        raise KeyError(f"No reverse complement registered for {sequence!r}")

    # --- position codec --------------------------------------------------

    def encode_position(self, sequence: Sequence, index: int) -> int:
        return int(self.starts[self.index_of(sequence)]) + index

    def decode_position(self, encoded: int) -> tuple[Sequence, int]:
        i = int(np.searchsorted(self.starts, encoded, side="right")) - 1
        return self.sequences[i], int(encoded - self.starts[i])

    def decode_positions(self, encoded: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Vectorized decode: returns (sequence_index, offset) arrays."""
        encoded = np.asarray(encoded, dtype=np.int64)
        seq_idx = np.searchsorted(self.starts, encoded, side="right") - 1
        offsets = encoded - self.starts[seq_idx]
        return seq_idx.astype(np.int32), offsets.astype(np.int64)

    def concatenated_codes(self) -> np.ndarray:
        """All sequences concatenated in database order — the device-resident
        reference array that global positions index into."""
        if self._concatenated is None:
            if self.sequences:
                self._concatenated = np.concatenate([s.codes for s in self.sequences])
            else:
                self._concatenated = np.zeros(0, dtype=np.uint8)
        return self._concatenated

    def get_cache_keys(self) -> dict[str, str]:
        """Content keys identifying this database for the on-disk cache
        (reference: SequenceDatabase.getCacheKeys via HashBlock_Database.java:107)."""
        import hashlib

        hasher = hashlib.sha256()
        for seq in self.get_forward_sequences_only():
            hasher.update(seq.name.encode())
            hasher.update(b"\x00")
            hasher.update(seq.codes.tobytes())
            hasher.update(b"\x01")
        return {
            "sequenceHash": hasher.hexdigest(),
            "numSequences": str(len(self.get_forward_sequences_only())),
            "totalForwardSize": str(self.get_total_forward_size()),
        }
