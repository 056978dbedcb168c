"""AOT serving artifacts: an engine boots with no capture after boot (the
port of ``paddle_tpu/serving/aot.py``).

The bucketed fixed-shape discipline makes the whole program set of an
engine **enumerable up front**: every shape it can dispatch is a point of a
small power-of-two lattice derived from the deployment config (pool
capacity, scheduler caps, chunk budgets, burst length).

* :func:`enumerate_buckets` walks that closed universe — the legacy
  families (one-shot ``prefill``, ``chunk``\\ ed prefill, batched
  ``decode``), or the one ``ragged`` family under
  ``EngineConfig.unified_step``, plus the ``burst`` family when
  ``burst_steps >= 2`` — the JAX lattice exactly.
* :meth:`AotArtifact.save` writes an artifact directory:
  ``kernels/``, the built library of every CUDA kernel the saved families
  launch, keyed by the hash ``ops/_build.py`` gives its sources, and
  ``manifest.json`` last, the commit record (the whole artifact is staged
  beside its destination and swapped in).  The manifest holds the
  deployment (model-config hash, pool geometry, dtype, scheduler caps,
  burst length, kernel routing), the environment (torch and CUDA versions,
  platform, device capability) and, for every ``(program, bucket)``, the
  argument signature of its step program: shape and dtype of each input.
* :meth:`AotArtifact.load` refuses an artifact of another version, torch
  or framework (a JAX-saved one names its framework) and, given the
  target device, of another platform or device capability; it refuses a
  kernel whose hash is not what this tree's ``csrc/`` hashes to, and
  loads the kernels' libraries with no ``nvcc``; one that fails to load
  raises :class:`AotError` and is never rebuilt.
* :meth:`AotArtifact.validate` is the mismatch matrix (the engine
  device's platform and capability, mp degree, model hash, pool
  geometry, layer count, dtype, unified flag, kernel routing, and bucket
  coverage last); ``EngineCore.bind_aot`` calls it, then seals
  the engine's step graphs to the saved universe: a key outside it raises
  :class:`AotBucketMissing`, and the trace counters never move.
* :meth:`AotArtifact.warm` captures every key of the universe on an
  engine — each ``(program, bucket)`` with ``any_sampled`` False and True
  — before it serves, so serving captures nothing.

The departures from the JAX artifact: a CUDA graph cannot be written to
disk, so there are no programs on disk (the manifest's signatures stand
for the StableHLO's ``in_avals``) and ``warm`` takes the engine whose
graphs it captures; ``kernels/`` is added; a program is a graph key per
``any_sampled``.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
import weakref
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops import _build
from .scheduler import bucket_size

# the port's own artifact format (no StableHLO programs; kernels/ added)
ARTIFACT_VERSION = 1
MANIFEST_NAME = "manifest.json"
FRAMEWORK = "paddle_tpu_torch"
_KERNEL_DIR = "kernels"

# metric names this module owns (registered by the StepProfiler when an
# artifact is bound, and by warm())
METRIC_NAMES = (
    "serving_aot_hits_total",
    "serving_aot_load_seconds",
    "serving_aot_warm_seconds",
)


class AotError(RuntimeError):
    """Base class for artifact save/load/dispatch failures."""


class AotManifestMismatch(AotError):
    """The artifact was saved for a DIFFERENT deployment or environment
    (mp degree, bucket set, model hash, pool geometry, torch version,
    device capability, framework, ...): boot fails loudly instead."""


class AotBucketMissing(AotError):
    """A serving step needed a (program, bucket) shape outside the
    artifact's saved universe: nothing is captured for it; re-save with a
    larger ``max_seq_len`` or matching scheduler caps."""


def _pow2_upto(cap: int) -> List[int]:
    """[1, 2, 4, ..., bucket_size(cap)] — the bucket lattice axis."""
    out, b = [], 1
    top = bucket_size(max(1, int(cap)))
    while b <= top:
        out.append(b)
        b <<= 1
    return out


def _max_seq_cap(engine, max_seq_len: Optional[int]) -> int:
    """The max-seq clamp shared by :meth:`AotArtifact.save` and
    :func:`enumerate_buckets`: the pool capacity ``(num_blocks - 1) *
    block_size`` caps whatever the caller asked for."""
    pool_cap = max(1, (engine.num_blocks - 1) * engine.block_size)
    return min(int(max_seq_len), pool_cap) if max_seq_len else pool_cap


def enumerate_buckets(engine, max_seq_len: Optional[int] = None,
                      ) -> List[Tuple[str, Tuple[int, ...]]]:
    """The CLOSED set of (program, bucket) shapes ``engine`` can ever
    dispatch for sequences up to ``max_seq_len`` tokens (default: the pool
    capacity), from the dispatch sites' own bucketing rules — the JAX
    package's lattice, entry for entry."""
    sched = engine.scheduler.config
    bs = engine.block_size
    max_seq = _max_seq_cap(engine, max_seq_len)
    # table width covers the whole sequence: ceil(max_seq / block_size)
    widths = _pow2_upto((max_seq + bs - 1) // bs)
    out: List[Tuple[str, Tuple[int, ...]]] = []
    # decode bursts (either dispatch mode): (rows, burst length) buckets;
    # the table width is pinned to the engine's burst width, and a burst
    # is at least 2 steps long
    burst_steps = int(getattr(engine, "_burst_steps", 0) or 0)
    if burst_steps >= 2:
        for b in _pow2_upto(sched.max_num_seqs):
            for n in _pow2_upto(burst_steps):
                if n >= 2:
                    out.append(("burst", (b, n)))
    pf_budget = sched.max_prefill_tokens_per_step
    if getattr(engine, "_unified", False):
        # one packed launch a step: decode rows are never split; without
        # a packed budget the per-step prefill total is capped by the
        # chunk budget, else by every running row prefilling its whole
        # remaining prompt at once
        total = sched.max_tokens_per_step
        if total is not None:
            tmax = max(int(total), sched.max_num_seqs)
        else:
            pf_cap = sched.max_num_seqs * max_seq
            if pf_budget is not None:
                pf_cap = min(int(pf_budget), pf_cap)
            tmax = sched.max_num_seqs + pf_cap
        for t in _pow2_upto(tmax):
            for w in widths:
                out.append(("ragged", (t, w)))
        return out
    # the legacy families: a one-shot prefill runs only when the whole
    # prompt fits one planning pass (n == target <= the chunk budget)
    oneshot = min(pf_budget or max_seq, max_seq)
    for t in _pow2_upto(oneshot):
        out.append(("prefill", (t,)))
    for c in _pow2_upto(oneshot):
        for w in widths:
            out.append(("chunk", (c, w)))
    for b in _pow2_upto(sched.max_num_seqs):
        for w in widths:
            out.append(("decode", (b, w)))
    return out


def _key_str(program: str, bucket: Tuple[int, ...]) -> str:
    return program + "_" + "x".join(str(int(b)) for b in bucket)


def _dtype_name(dtype) -> str:
    return str(dtype).rsplit(".", 1)[-1]


def _arg_sig(a) -> list:
    """``[shape, dtype]`` of one step-program input."""
    if isinstance(a, torch.Tensor):
        return [list(a.shape), _dtype_name(a.dtype)]
    a = np.asarray(a)
    return [list(a.shape), str(a.dtype)]


def _signature(engine, program: str, bucket: Tuple[int, ...]) -> list:
    """The argument signature of one step program: each input's shape and
    dtype, as the engine launches it."""
    return [_arg_sig(a) for a in engine.program_inputs(program, bucket)]


def model_config_hash(engine) -> str:
    """Digest of the deployment's MODEL IDENTITY: the model config's
    scalar fields plus every parameter's (shape, dtype).  Weight VALUES are
    not hashed: an artifact serves any checkpoint of the architecture."""
    cfg = engine.model.config
    fields = {k: v for k, v in sorted(vars(cfg).items())
              if isinstance(v, (int, float, str, bool, type(None)))}
    params = [[list(p.shape), _dtype_name(p.dtype)]
              for p in engine.model.parameters()]
    blob = json.dumps({"config": fields, "params": params},
                      sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()


def engine_kernels(engine) -> List[str]:
    """The CUDA kernels ``engine``'s step programs launch: the ragged
    kernel for the unified step, the decode kernel for the legacy decode
    step and for bursts (either mode); none on the CPU or with the plain
    versions pinned."""
    from ..ops import paged_decode, ragged_paged

    if engine.device.type != "cuda" \
            or engine.engine_config.use_pallas_paged is False:
        return []
    names = [ragged_paged._KERNEL] if engine._unified \
        else [paged_decode._KERNEL]
    if engine._burst_steps >= 2 and paged_decode._KERNEL not in names:
        names.append(paged_decode._KERNEL)
    return names


def _capability(device: torch.device) -> Optional[str]:
    """``sm_<major><minor>`` of ``device``'s card, None on the CPU."""
    if device.type != "cuda":
        return None
    major, minor = torch.cuda.get_device_capability(device)
    return f"sm_{major}{minor}"


def _device_mismatches(manifest: Dict, device: torch.device) -> List[str]:
    """How ``manifest``'s platform and card disagree with ``device``."""
    mm = []
    if manifest.get("platform") != device.type:
        mm.append(f"platform: artifact {manifest.get('platform')!r}, "
                  f"device {device.type!r}")
    if manifest.get("device_capability") != _capability(device):
        mm.append(f"device capability: artifact "
                  f"{manifest.get('device_capability')!r}, device "
                  f"{_capability(device)!r}")
    return mm


def read_manifest(path: str) -> Dict:
    """The manifest of the artifact at ``path`` (nothing else is read)."""
    mpath = os.path.join(path, MANIFEST_NAME)
    if not os.path.exists(mpath):
        raise AotError(
            f"no AOT artifact at {path!r}: {MANIFEST_NAME} missing "
            "(unsaved, or a save was torn before commit)")
    with open(mpath) as f:
        return json.load(f)


class AotArtifact:
    """One saved-or-loaded serving program universe and its manifest.

    Save side: :meth:`save` enumerates a saving engine's universe and
    writes the artifact.  Load side: :meth:`load` → :meth:`validate`
    (``EngineCore.bind_aot`` calls it) → :meth:`warm` → :meth:`call` at
    every step dispatch.  One loaded artifact is SHARED across a fleet's
    replicas and the supervisor's rebuilds."""

    def __init__(self, manifest: Dict, path: str,
                 load_seconds: float = 0.0):
        self.manifest = manifest
        # (program, bucket...) -> argument signature
        self._programs: Dict[Tuple, list] = {
            (meta["program"],) + tuple(meta["bucket"]): meta["args"]
            for meta in manifest["programs"].values()}
        self.path = path
        self.load_seconds = float(load_seconds)
        # registries that already observed this artifact's load: ONE load
        # lands as ONE serving_aot_load_seconds sample per registry
        self._observed_registries = weakref.WeakSet()

    def mark_load_observed(self, registry) -> bool:
        """True exactly once per (this artifact, ``registry``)."""
        if registry in self._observed_registries:
            return False
        self._observed_registries.add(registry)
        return True

    # --- inspection ---------------------------------------------------------
    @property
    def program_count(self) -> int:
        """The saved (program, bucket) pairs; each is two graph keys
        (``any_sampled`` False and True)."""
        return len(self._programs)

    @property
    def bucket_sets(self) -> Dict[str, List[Tuple[int, ...]]]:
        out: Dict[str, List] = {}
        for key in self._programs:
            out.setdefault(key[0], []).append(tuple(key[1:]))
        return {p: sorted(v) for p, v in sorted(out.items())}

    def graph_keys(self) -> List[Tuple]:
        """Every step-graph key of the universe: each saved (program,
        bucket) with ``any_sampled`` False and True."""
        return [key + (s,) for key in sorted(self._programs)
                for s in (False, True)]

    def describe(self) -> Dict:
        m = self.manifest
        return {
            "path": self.path,
            "programs": self.program_count,
            "families": {p: len(v) for p, v in self.bucket_sets.items()},
            "mp": m["mp"], "dtype": m["dtype"],
            "num_blocks": m["num_blocks"], "block_size": m["block_size"],
            "max_seq_len": m["max_seq_len"],
            "unified_step": m["autotune"]["unified_step"],
            "burst_steps": m.get("burst_steps", 0),
            "model_hash": m["model_hash"][:16],
            "torch_version": m["torch_version"],
            "device_capability": m["device_capability"],
            "kernels": sorted(m["kernels"]),
            "load_seconds": round(self.load_seconds, 4),
        }

    # --- save ---------------------------------------------------------------
    @classmethod
    def save(cls, engine, path: str,
             max_seq_len: Optional[int] = None) -> "AotArtifact":
        """Write ``engine``'s full bucketed universe into the ``path``
        directory.  ``max_seq_len`` bounds it (default: pool capacity).
        The saved set is always the full :func:`enumerate_buckets`
        lattice: :meth:`validate` requires exactly that coverage.  An
        engine at mp > 1 raises naming ROADMAP A11."""
        engine._single_rank("AOT artifacts")
        t0 = time.perf_counter()
        sched = engine.scheduler.config
        max_seq = _max_seq_cap(engine, max_seq_len)
        # burst programs pin their table width to ONE max_seq-derived
        # bucket; align the saving engine's with the universe saved (it
        # is what bind_aot re-derives from the manifest at load)
        engine._burst_width = bucket_size(
            max(1, (max_seq + engine.block_size - 1) // engine.block_size))
        buckets = enumerate_buckets(engine, max_seq)
        # staged next to the destination and swapped in only after the
        # manifest commit: a re-save that dies midway leaves the previous
        # artifact untouched and loadable
        stage = path.rstrip("/") + ".staging"
        if os.path.exists(stage):
            shutil.rmtree(stage)
        kdir = os.path.join(stage, _KERNEL_DIR)
        os.makedirs(kdir)
        prog_meta: Dict[str, Dict] = {}
        kernels: Dict[str, Dict] = {}
        try:
            for program, bucket in buckets:
                bucket = tuple(int(b) for b in bucket)
                prog_meta[_key_str(program, bucket)] = {
                    "program": program, "bucket": list(bucket),
                    "args": _signature(engine, program, bucket)}
            names = engine_kernels(engine)
            _build.build(names)
            for name in names:
                src = _build.library_path(name)
                fname = _KERNEL_DIR + "/" + src.name
                shutil.copyfile(src, os.path.join(stage, fname))
                kernels[name] = {"file": fname,
                                 "hash": _build.source_hash(name)}
        except BaseException:
            shutil.rmtree(stage, ignore_errors=True)
            raise
        from ..version import full_version

        manifest = {
            "artifact_version": ARTIFACT_VERSION,
            "framework": FRAMEWORK,
            "framework_version": full_version,
            "torch_version": torch.__version__,
            "cuda_version": torch.version.cuda,
            "platform": engine.device.type,
            "device_capability": _capability(engine.device),
            "created_unix": round(time.time(), 3),
            "model_hash": model_config_hash(engine),
            "mp": int(engine.mp),
            "dtype": _dtype_name(engine._pool_dtype),
            "num_blocks": int(engine.num_blocks),
            "block_size": int(engine.block_size),
            "num_layers": len(engine._k_pools),
            "max_seq_len": int(max_seq),
            "scheduler": {
                "max_num_seqs": sched.max_num_seqs,
                "max_prefill_tokens_per_step":
                    sched.max_prefill_tokens_per_step,
                "max_tokens_per_step": sched.max_tokens_per_step,
            },
            # not a validate() row: a burst-off engine may bind a burst-on
            # artifact (a superset); a larger burst_steps fails coverage
            "burst_steps": int(engine._burst_steps),
            "autotune": {
                "use_pallas_paged": engine.engine_config.use_pallas_paged,
                "unified_step": bool(engine._unified),
            },
            # recorded for inspection only: spec decoding packs into the
            # same ragged lattice, so one artifact serves spec on and off
            "spec": (engine.spec.config.manifest_dict()
                     if engine.spec is not None else None),
            "kernels": kernels,
            "programs": prog_meta,
            "save_seconds": round(time.perf_counter() - t0, 4),
        }
        # manifest LAST, atomically: its presence is the commit record
        tmp = os.path.join(stage, MANIFEST_NAME + ".tmp")
        with open(tmp, "w") as f:
            json.dump(manifest, f, indent=1, sort_keys=True)
        os.replace(tmp, os.path.join(stage, MANIFEST_NAME))
        if os.path.exists(path):
            old = path.rstrip("/") + ".old"
            if os.path.exists(old):
                shutil.rmtree(old)
            os.rename(path, old)
            os.rename(stage, path)
            shutil.rmtree(old)
        else:
            os.rename(stage, path)
        return cls(manifest, path)

    # --- load ---------------------------------------------------------------
    @classmethod
    def load(cls, path: str, device=None) -> "AotArtifact":
        """Read the manifest, refuse an artifact saved for another
        environment (with ``device``, the device of the engines it will
        bind to, also one saved for another platform or card), check every
        kernel's hash against this tree's sources, and load the kernels'
        libraries (no ``nvcc``).  Deployment mismatches, and the platform
        and card of each engine bound, fail in :meth:`validate`."""
        t0 = time.perf_counter()
        manifest = read_manifest(path)
        mm: List[str] = []
        if manifest.get("framework") != FRAMEWORK:
            mm.append(f"framework {manifest.get('framework')!r}: the "
                      f"artifact was not saved by {FRAMEWORK} (a JAX "
                      "package artifact holds StableHLO programs, which "
                      "the port cannot run)")
        if manifest.get("artifact_version") != ARTIFACT_VERSION:
            mm.append(f"artifact_version "
                      f"{manifest.get('artifact_version')!r} != supported "
                      f"{ARTIFACT_VERSION}")
        if mm:
            raise AotManifestMismatch(
                f"refusing to load AOT artifact {path!r}:\n  - "
                + "\n  - ".join(mm))
        if manifest.get("torch_version") != torch.__version__:
            mm.append(f"artifact was saved under torch "
                      f"{manifest.get('torch_version')!r} but "
                      f"{torch.__version__} is installed (stale artifact — "
                      "re-save after upgrading)")
        if device is not None:
            mm += _device_mismatches(manifest, torch.device(device))
        for name, meta in sorted(manifest.get("kernels", {}).items()):
            if not (_build.CSRC_DIR / f"{name}.cu").exists():
                mm.append(f"kernel {name!r}: no csrc/{name}.cu in this "
                          "tree")
            elif meta.get("hash") != _build.source_hash(name):
                mm.append(f"kernel {name!r}: the artifact's library was "
                          f"built from sources hashing to "
                          f"{meta.get('hash')!r}, this tree's csrc/ hashes "
                          f"to {_build.source_hash(name)!r}")
        if mm:
            raise AotManifestMismatch(
                f"refusing to load AOT artifact {path!r}:\n  - "
                + "\n  - ".join(mm))
        for name, meta in sorted(manifest["kernels"].items()):
            fpath = os.path.join(path, meta["file"])
            try:
                _build.load_library(name, fpath)
            except OSError as e:
                raise AotError(
                    f"AOT artifact {path!r}: kernel {name!r} failed to "
                    f"load from {meta['file']!r} ({e}); it is not rebuilt"
                ) from e
        return cls(manifest, path, load_seconds=time.perf_counter() - t0)

    # --- validation (the mismatch matrix) -----------------------------------
    def validate(self, engine) -> None:
        """Raise :class:`AotManifestMismatch` naming EVERY way this
        artifact disagrees with ``engine``'s deployment."""
        m = self.manifest
        mm = _device_mismatches(m, engine.device)
        if m["mp"] != engine.mp:
            mm.append(f"mp degree: artifact {m['mp']}, engine {engine.mp}")
        if m["model_hash"] != model_config_hash(engine):
            mm.append("model-config hash: the artifact was saved for a "
                      "different architecture/parameter layout")
        if m["num_blocks"] != engine.num_blocks \
                or m["block_size"] != engine.block_size:
            mm.append(
                f"pool geometry: artifact {m['num_blocks']}x"
                f"{m['block_size']}, engine {engine.num_blocks}x"
                f"{engine.block_size} (pool tensors are program inputs "
                "— shapes must match exactly)")
        if m["num_layers"] != len(engine._k_pools):
            mm.append(f"layer count: artifact {m['num_layers']}, engine "
                      f"{len(engine._k_pools)}")
        if m["dtype"] != _dtype_name(engine._pool_dtype):
            mm.append(f"pool dtype: artifact {m['dtype']}, engine "
                      f"{_dtype_name(engine._pool_dtype)}")
        if bool(m["autotune"]["unified_step"]) != bool(engine._unified):
            mm.append(
                f"program family: artifact saved "
                f"unified_step={m['autotune']['unified_step']}, engine "
                f"runs unified_step={engine._unified}")
        if m["autotune"]["use_pallas_paged"] \
                != engine.engine_config.use_pallas_paged:
            mm.append(
                f"kernel routing: artifact saved use_pallas_paged="
                f"{m['autotune']['use_pallas_paged']}, engine configured "
                f"{engine.engine_config.use_pallas_paged}")
        if not mm:
            # bucket-set coverage LAST: everything the engine's caps can
            # dispatch within the artifact's max_seq_len must be saved
            required = set(
                (p,) + tuple(b) for p, b in enumerate_buckets(
                    engine, max_seq_len=m["max_seq_len"]))
            missing = sorted(required - set(self._programs))
            if missing:
                mm.append(
                    f"bucket set: engine scheduler caps need "
                    f"{len(missing)} program shape(s) the artifact never "
                    f"saved (first: {missing[:4]}) — scheduler config "
                    "drifted since the save")
        if mm:
            raise AotManifestMismatch(
                f"AOT artifact {self.path!r} does not match this engine:"
                + "".join(f"\n  - {x}" for x in mm)
                + "\n(re-save the artifact for THIS deployment)")

    # --- serving dispatch ---------------------------------------------------
    def _missing(self, program: str, bucket) -> AotBucketMissing:
        saved = self.bucket_sets
        return AotBucketMissing(
            f"step program {program!r} bucket "
            f"{tuple(int(b) for b in bucket)} is outside the artifact's "
            f"saved universe (max_seq_len={self.manifest['max_seq_len']}, "
            f"saved { {p: len(v) for p, v in saved.items()} }); nothing is "
            "captured for it — re-save with a larger max_seq_len / "
            "matching scheduler caps")

    def check_key(self, key: Tuple) -> None:
        """Raise :class:`AotBucketMissing` unless ``key`` — ``(program,
        bucket..., any_sampled)`` — is a step-graph key of the universe
        (``StepGraphs.run`` asks, once sealed)."""
        if not isinstance(key[-1], bool) or key[:-1] not in self._programs:
            raise self._missing(key[0], key[1:-1])

    def call(self, program: str, bucket: Tuple[int, ...], *args) -> None:
        """The dispatch-level check of one launch: its (program, bucket)
        must be saved (else :class:`AotBucketMissing`) and ``args`` must
        match the saved signature (else :class:`AotError`)."""
        key = (program,) + tuple(int(b) for b in bucket)
        sig = self._programs.get(key)
        if sig is None:
            raise self._missing(program, bucket)
        if len(args) != len(sig):
            raise AotError(
                f"{program} {bucket}: argument count {len(args)} != "
                f"saved {len(sig)} (framework drift — re-save)")
        for i, (a, want) in enumerate(zip(args, sig)):
            got = _arg_sig(a)
            if got != want:
                raise AotError(
                    f"{program} {bucket}: argument {i} is {got}, the "
                    f"artifact saved {want} (framework drift — re-save)")

    def warm(self, engine, registry=None,
             labels: Optional[Dict] = None) -> float:
        """Capture every step-graph key of the universe on ``engine`` —
        each saved (program, bucket) with ``any_sampled`` False and True —
        on pad inputs, so serving captures nothing.  The engine is bound
        to this artifact, or (the saving engine) validated against
        it.  A pad input writes the null page only.  Returns the wall
        seconds; recorded as ``serving_aot_warm_seconds`` when a
        ``registry`` is given."""
        if engine.aot_artifact is not self:
            self.validate(engine)
        from .graphs import capture_batch

        t0 = time.perf_counter()
        with capture_batch():
            for key in self.graph_keys():
                engine.warm_program(key[0], key[1:-1], key[-1])
        if engine.device.type == "cuda":
            torch.cuda.synchronize(engine.device)
        wall = time.perf_counter() - t0
        if registry is not None:
            registry.gauge(
                "serving_aot_warm_seconds",
                "wall seconds capturing every step program of the AOT "
                "artifact's universe (warm boot/save)",
                **(labels or {})).set(wall)
        return wall
