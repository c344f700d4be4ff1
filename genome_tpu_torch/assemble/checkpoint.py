"""Phase-boundary checkpoint/resume (SURVEY.md §5.3-§5.4).

Port of genome_tpu/assemble/checkpoint.py. Each pipeline phase emits
clean array artifacts (torch tensors are moved to the host); they are
saved per phase as .npz next to a manifest carrying the params hash,
shard info, the device count and a content hash. `--resume` skips phases
whose artifacts match the manifest. The port's artifacts are its own
format (one int64 key array where the JAX package stores (hi, lo)), so
it never resumes from a JAX checkpoint: their array names differ.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import torch

from genome_tpu_torch.params import AssemblyParams

MANIFEST = "manifest.json"


def device_count(device) -> int:
    """The topology the manifest pins: CUDA devices visible, or 1 on CPU."""
    return torch.cuda.device_count() if torch.device(device).type == "cuda" \
        else 1


def _content_hash(arrays: dict) -> str:
    h = hashlib.sha256()
    for name in sorted(arrays):
        a = np.ascontiguousarray(arrays[name])
        h.update(name.encode())
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()[:16]


def input_digest(reads) -> str:
    """Digest of the local read stream for checkpoint validation.

    Count/build tables are owner-hashed per device; resuming against a
    modified input (or a different topology) would pass params/shard
    checks yet silently produce wrong contigs. Accepts the two read
    representations the pipeline does: a uint8 code matrix (native IO)
    or a list of strings.
    """
    h = hashlib.sha256()
    if isinstance(reads, np.ndarray):
        a = np.ascontiguousarray(reads)
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    else:
        for r in reads:
            h.update(r.encode() if isinstance(r, str) else bytes(r))
            h.update(b"\n")
    return h.hexdigest()[:16]


class PhaseCheckpointer:
    """Saves/loads per-phase artifacts under dir/<phase>.npz + manifest.

    Beyond params_hash/num_shards/content_hash, the manifest records the
    TOTAL device count (mesh size = processes x local devices — count
    tables are owner-hashed per device, so a topology change invalidates
    them even at the same process count) and a digest of the input read
    stream; load() rejects on any mismatch.
    """

    def __init__(self, directory: str | None, params: AssemblyParams,
                 shard: int = 0, num_shards: int = 1,
                 load_enabled: bool = True,
                 n_devices: int | None = None,
                 input_digest: str | None = None):
        self.dir = directory
        self.params_hash = params.params_hash()
        self.shard = shard
        self.num_shards = num_shards
        self.load_enabled = load_enabled  # False: write-only (fresh run)
        self.n_devices = n_devices
        self.input_digest = input_digest
        if directory:
            os.makedirs(directory, exist_ok=True)

    def _manifest_path(self) -> str:
        # one manifest per shard: concurrent processes of a distributed
        # job never read-modify-write the same file (shard 0 keeps the
        # legacy name so single-host checkpoints stay readable)
        if self.shard == 0:
            return os.path.join(self.dir, MANIFEST)
        return os.path.join(self.dir, f"manifest.shard{self.shard}.json")

    def _load_manifest(self) -> dict:
        try:
            with open(self._manifest_path()) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError):
            return {}

    def _phase_file(self, phase: str) -> str:
        return os.path.join(self.dir, f"{phase}.shard{self.shard}.npz")

    def save(self, phase: str, **arrays) -> None:
        if not self.dir:
            return
        arrays = {k: v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
                  for k, v in arrays.items()}
        np.savez_compressed(self._phase_file(phase), **arrays)
        man = self._load_manifest()
        man.setdefault("phases", {})[f"{phase}.shard{self.shard}"] = {
            "params_hash": self.params_hash,
            "num_shards": self.num_shards,
            "content_hash": _content_hash(arrays),
            "n_devices": self.n_devices,
            "input_digest": self.input_digest,
        }
        man["params_hash"] = self.params_hash
        with open(self._manifest_path(), "w") as f:
            json.dump(man, f, indent=2, sort_keys=True)

    def load(self, phase: str) -> dict | None:
        """Returns saved arrays iff manifest matches params + shards; else None."""
        if not self.dir or not self.load_enabled:
            return None
        man = self._load_manifest().get("phases", {}).get(
            f"{phase}.shard{self.shard}")
        if not man or man.get("params_hash") != self.params_hash \
                or man.get("num_shards") != self.num_shards \
                or man.get("n_devices") != self.n_devices \
                or man.get("input_digest") != self.input_digest:
            return None
        try:
            with np.load(self._phase_file(phase)) as z:
                arrays = {k: z[k] for k in z.files}
        except Exception:  # corrupt/partial npz (BadZipFile, EOFError, ...)
            return None
        if _content_hash(arrays) != man.get("content_hash"):
            return None  # corrupted/partial write -> recompute
        return arrays
