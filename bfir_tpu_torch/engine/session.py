"""Streaming session: ``StreamProcessor`` on PyTorch.

Counterpart of ``bfir_tpu/engine/session.py`` (the plugin's DSP object,
foo_dsp_bfir.cpp:76-410) for every engine mode: ``complex``, ``hc``,
``packed``, ``nonuniform``, ``nonuniform_split``, ``nonuniform3``,
``extended`` (float64) and ``sharded`` (``parallel.sharded`` over a device
mesh):
lazy (re)initialization on a format change, chain build, re-blocking into
N-frame blocks, the NaN/Inf abort to passthrough, overflow accounting,
glitch-free ``reconfigure`` crossfades, per-channel output delay lines
(``EngineConfig.delay``, values changed live), ``process_buffer`` for bulk
input, ``render``, the offline bulk engine (``core.bulk``), and
``process_raw``, raw PCM bytes in and out through the output stage (hp-TPDF
dither and error feedback, kernel K9).

The device is explicit: ``StreamProcessor(config, *, device="cuda")`` runs
the CUDA kernels and raises if CUDA is missing; ``device="cpu"`` runs their
plain versions. ``mesh`` (``parallel.mesh.make_mesh``) is the sharded
engine's mesh, of the session's device type; by default every visible
device of that type on the partition axis ((1, 1) on the CPU). The
session drives a one-process mesh: a mesh that spans processes, or the
default mesh inside a process group, raises ``ValueError`` (as the
reference's session, which fetches each sharded output to the host, cannot
run on one; ``parallel.sharded.ShardedEngine`` spans processes). Where
this session diverges from the reference:

- no engine fall-through: a kernel build or launch error, or a refused
  known-answer self-check, propagates (the reference catches every
  exception and tries the next engine). A chain that fails to build (a bad
  impulse file) still passes the stream through, as the reference does;
- the short-filter rules are decided from the geometry before building:
  three-stage -> ``nonuniform`` when two stages cover the filter, and
  two-stage -> ``hc`` when the head alone covers it (the reference reaches
  the same engines by falling through); the sharded engine's local engine
  likewise (``parallel.sharded.geometry_refusal``);
- ``engine_mode="auto"`` on CUDA picks ``nonuniform3`` for 640 partitions
  or more and ``nonuniform`` for 32 or more, as the reference does on an
  accelerator, and ``extended`` for float64, where it is native float64
  (``kernels.extended``) instead of the reference's df64;
- ``packed``, ``nonuniform3`` and ``sharded`` at float64 on CUDA raise
  ``NotImplementedError`` naming ``extended`` (their kernels store
  float32); ``sharded`` with an integer tail store raises ``ValueError``;
- ``extended`` outputs float64 on every host (the reference: only on x64
  hosts);
- ``nonuniform_split`` builds ``nonuniform`` (and so ``hc`` where the
  head alone covers the filter) when its tail planes do not split into R
  128-lane bands (N <= 64), the engine the reference's fall-through
  reaches; where they split, a filter the head alone covers raises
  ``ValueError`` (the reference tries the next engine);
- the block counter is a host int, so no block waits on the device to
  learn its phase;
- the dither bytes come from a ``torch.Generator`` (the reference: JAX's
  threefry), so dithered output matches the reference in its statistics
  only;
- ``process_raw`` runs under the session lock, output stage included.

Tracing: a ``utils.profiling.Tracer`` set as ``StreamProcessor.tracer``
(None, the default, is off) records each call of the block loop
(``process``, and ``process_raw`` and crossfades through it) as one
``session.process`` span with ``session.to_device`` (the block's input
copy), ``engine.step`` (the engine's step; ``extended`` records its phases
inside, or on a CUDA device one ``engine.replay`` of its graph, and the
two- and three-stage engines an ``engine.head`` a block, on a CUDA device
``nonuniform``'s the replay of its ring slot's graph, and an
``engine.tail`` a fire),
``session.fetch`` (a drain's join and device-to-host copy, which waits for
the device), ``session.guard`` (the NaN check) and ``session.overflow``
(the float output's overflow count, one pass a drain over the good blocks'
fetched samples, on the host) inside it, and counts the blocks stepped in
``session.blocks``, those passes in ``session.overflow_passes`` (and
``extended``'s graph replays in ``engine.graph_replays``,
``nonuniform``'s head replays in ``engine.head_replays``, the captures of
either in ``engine.graph_captures`` (``utils.graphs``, the one graph
mechanism), and the stage engines' tail fires in ``engine.tail_fires``).
Every block, a crossfade's too, is fetched and NaN-guarded by one drain.
"""

from __future__ import annotations

import functools
import math
import threading
import time
from typing import Optional

import numpy as np
import torch

from bfir_tpu_torch.core import bulk as BK
from bfir_tpu_torch.core import convolver as cv
from bfir_tpu_torch.core import nonuniform as NU
from bfir_tpu_torch.core.spec import EngineConfig, FilterSpec, StreamSpec
from bfir_tpu_torch.engine import selfcheck
from bfir_tpu_torch.engine.cache import ArtifactCache
from bfir_tpu_torch.engine.chain import build_chain
from bfir_tpu_torch.kernels import extended as E
from bfir_tpu_torch.kernels import spectrum_mac as K
from bfir_tpu_torch.ops import delay as DL
from bfir_tpu_torch.ops import dither as dth
from bfir_tpu_torch.ops import formats as fm
from bfir_tpu_torch.parallel import mesh as M
from bfir_tpu_torch.parallel import sharded as SH
from bfir_tpu_torch.utils.device import resolve_device
from bfir_tpu_torch.utils.logging import pinfo
from bfir_tpu_torch.utils import profiling as P

_ONE_PROCESS = ("the session drives a one-process mesh; a mesh that spans "
                "processes runs through parallel.sharded.ShardedEngine")


def _scan(step, state, coeffs, blocks: torch.Tensor):
    """``step`` over blocks [B, C, N] -> (state, out [B, C, N])."""
    outs = []
    for blk in blocks:
        state, y = step(state, coeffs, blk)
        outs.append(y)
    return state, torch.stack(outs)


class StreamProcessor:
    # maximum blocks stepped ahead of their output fetch
    MAX_INFLIGHT = 64

    def __init__(self, config: EngineConfig,
                 cache: Optional[ArtifactCache] = None, *, device,
                 mesh: Optional[M.Mesh] = None):
        self.device = resolve_device(device)
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(f"mesh devices are {mesh.device_type}, the "
                             f"session's device is {self.device.type}")
        if mesh is not None and mesh.spans_processes:
            raise ValueError(_ONE_PROCESS)
        self._mesh = mesh
        self._sharded = None  # parallel.sharded.ShardedEngine of "sharded"
        self.config = config
        self.cache = cache or ArtifactCache()
        self._channels = 0
        self._rate = 0
        self._active = False
        self._failed = False
        self._state = None
        self._coeffs = None
        self._pending = None  # np [C, <N] partial input block
        self._lock = threading.RLock()
        self._pending_swap = None
        self._impl = "complex"
        self._step = None
        self._init_state = None
        self._nuspec = None
        self._nu_old = None  # old coeffs during a two- or three-stage change
        self._nu3_stage = None  # "outer" | "inner" during a nu3 transition
        self._bulk = None  # lazy BulkRenderer for render() (core/bulk.py)
        self._built_impulse = None  # chain impulse the current coeffs use
        self._built_scale = 1.0
        self._overflow = None  # device stats: the integer output stage's
        self._overflow_host = None  # host partial: the float output's
        self._overflow_scratch = None  # |y| of a drain (_abs_scratch)
        self._last_overflow = None
        self._dither_state = None
        self._delay_fn = None  # apply_delay or a FractionalDelayLine
        self._delay_state = None
        self._delay_vecs = ()
        self._delay_dmax = 0
        # seconds spent by process_raw in its four phases, summed over calls
        self.raw_seconds = dict.fromkeys(("decode", "engine", "output",
                                          "encode"), 0.0)
        self.reported_latency = 0  # parity: foo_dsp_bfir.cpp:372-375
        self.n_partitions = 0
        self.tracer: Optional[P.Tracer] = None  # set one to trace calls

    # -- lifecycle ----------------------------------------------------------

    @property
    def algorithmic_latency(self) -> int:
        return self.config.filter.block_length

    def reconfigure(self, config: EngineConfig) -> None:
        """Swap the config snapshot. When the new chain keeps the engine
        geometry, the next block crossfades from the old filter to the new
        one; otherwise the engine rebuilds at the next block."""
        with self._lock:
            self._reconfigure_locked(config)

    def _reconfigure_locked(self, config: EngineConfig) -> None:
        old_cfg = self.config
        self.config = config
        self._failed = False
        if not self._channels or not self._active:
            self._channels = 0  # full (re)build on next process()
            return
        # delay values change live (change_delay, delay.cpp:552-600); the
        # line's build parameters, or a delay beyond its history, rebuild
        d_old, d_new = old_cfg.delay, config.delay
        delay_compat = d_new.enabled == d_old.enabled and (
            not d_new.enabled
            or (d_new.fractional == d_old.fractional
                and d_new.step_count == d_old.step_count
                and d_new.half_length == d_old.half_length
                and max(d_new.samples) <= self._delay_dmax))
        same_geom = (
            config.filter.block_length == old_cfg.filter.block_length
            and config.filter.dtype == old_cfg.filter.dtype
            and config.stream.apply_dither == old_cfg.stream.apply_dither
            and config.nu_tail_store == old_cfg.nu_tail_store
            and config.nu_head_store == old_cfg.nu_head_store
            and config.sharded_local == old_cfg.sharded_local
            and delay_compat)
        if (not same_geom or self._impl == "nonuniform_split"
                or (self._impl == "nonuniform3" and self._nu_old is not None)):
            # the split schedule's staged state has no two-filter bridge,
            # and a second change landing mid-way through a three-stage
            # transition is not composed: reconfigure = rebuild, as the
            # reference
            self._channels = 0
            self._pending_swap = None
            return
        stream = StreamSpec(
            n_channels=self._channels, sample_rate=self._rate,
            in_format=config.stream.in_format,
            out_format=config.stream.out_format,
            apply_dither=config.stream.apply_dither)
        try:
            built = build_chain(config, stream, self.cache)
        except Exception as e:  # a bad impulse file: pass through (parity)
            pinfo("Chain rebuild failed (%s); passing through.", e)
            self._active = False
            return
        if built.impulse is None or built.n_partitions != self.n_partitions:
            self._channels = 0  # geometry changed (or chain gone): rebuild
            self._pending_swap = None
            if built.impulse is None:
                self._active = False
            return
        if self._impl == "sharded" and (
                self._sharded.local_impl == "nonuniform3"
                or self._sharded.shared_coeffs != (
                    self._sharded.local_impl != "complex"
                    and self._impulse_shared(built.impulse))):
            # the sharded three-stage engine has no live crossfade, and the
            # coefficients' layout (shared or per channel) is the engine's:
            # reconfigure = rebuild, as the reference
            self._channels = 0
            self._pending_swap = None
            return
        self._pending_swap = self._build_coeffs(built)
        self._keep_built(built)
        if d_new.enabled:
            self._delay_vecs = self._delay_vectors()

    def _keep_built(self, built) -> None:
        """Remember the impulse the current coefficients come from; the
        render engine follows it."""
        self._built_impulse = np.atleast_2d(np.asarray(built.impulse))
        self._built_scale = built.scale
        self._bulk = None

    def reset(self) -> None:
        """brutefir::reset (brutefir.cpp:345-367): clear all running state."""
        if self._channels and self._init_state is not None:
            self._init_runtime_state()

    def _resolve_nu_tail_store(self, engine: str) -> str:
        """nu_tail_store="auto" for ``engine`` ("nonuniform" for both
        two-stage kinds, or "nonuniform3"): int24 for the two-stage engines
        on CUDA; float32 for the three-stage engine and on the CPU (it gains
        nothing from compressed storage). An explicit tier passes through."""
        v = self.config.nu_tail_store
        if v != "auto":
            return v
        if engine == "nonuniform" and self.device.type == "cuda":
            return "int24"
        return "float32"

    def _resolve_engine_mode(self) -> str:
        mode = self.config.engine_mode
        if mode != "auto":
            return mode
        if self.device.type == "cpu":
            return "complex"
        if self.config.filter.dtype == "float64":
            return "extended"  # the kernels store float32 or narrower
        if self.n_partitions >= 640:  # the reference's threshold
            return "nonuniform3"
        if self.n_partitions >= 32:
            return "nonuniform"
        return "hc"

    def _nu_geometry(self, fspec: FilterSpec, impl: str) -> NU.NuSpec:
        """Two-stage geometry; the split schedule's head is float32."""
        n = fspec.block_length
        return NU.nu_geometry(
            fspec.n_partitions * n, n, ratio=8, dtype=fspec.dtype,
            tail_store=self._resolve_nu_tail_store("nonuniform"),
            head_store=(self.config.nu_head_store if impl == "nonuniform"
                        else "float32"))

    def _nu3_geometry(self, fspec: FilterSpec) -> NU.Nu3Spec:
        """Three-stage geometry (``nu_head_store`` does not apply)."""
        n = fspec.block_length
        return NU.nu3_geometry(
            fspec.n_partitions * n, n, ratio1=8, ratio2=8, dtype=fspec.dtype,
            tail_store=self._resolve_nu_tail_store("nonuniform3"))

    def _init_runtime_state(self) -> None:
        fspec = self._runtime_filter_spec
        dt = getattr(torch, fspec.dtype)
        self._state = self._init_state()
        self._nu_old = None
        self._nu3_stage = None
        self._pending = np.zeros((self._channels, 0), dtype=fspec.dtype)
        self._overflow = dth.init_overflow_stats(self._channels, dtype=dt,
                                                 device=self.device)
        self._overflow_host = None
        self._last_overflow = self.overflow_stats()
        stream = self.config.stream
        self._dither_state = (
            dth.init_dither_state(self._channels, dtype=dt,
                                  device=self.device)
            if stream.apply_dither and not stream.out_format.isfloat
            else None)
        self._build_delay(dt)

    def _delay_vectors(self):
        """The configured delays as device vectors: (samples,) or (samples,
        substeps)."""
        dcfg = self.config.delay
        samples, substeps = dcfg.per_channel(self._channels)
        vecs = (torch.tensor(samples, dtype=torch.int64, device=self.device),)
        if dcfg.fractional:
            vecs += (torch.tensor(substeps, dtype=torch.int64,
                                  device=self.device),)
        return vecs

    def _build_delay(self, dtype) -> None:
        """The per-channel output delay line (EngineConfig.delay, the
        reference library's delay.cpp:495-600, applied to the engine's
        output as brutefir's run loop does). Integer delays gather from a
        history (``ops.delay.apply_delay``); any nonzero subsample step
        takes the Kaiser-sinc bank (``ops.delay.FractionalDelayLine``),
        which adds ``half_length`` samples of latency."""
        dcfg = self.config.delay
        if not dcfg.enabled:
            self._delay_fn = None
            self._delay_state = None
            self._delay_vecs = ()
            self._delay_dmax = 0
            return
        samples, _ = dcfg.per_channel(self._channels)
        self._delay_dmax = max(max(samples), 1)
        if dcfg.fractional:
            line = DL.FractionalDelayLine(
                self._channels, self._delay_dmax, dcfg.step_count,
                dcfg.half_length, dtype=dtype, device=self.device)
            self._delay_fn = line
            self._delay_state = line.init_state()
        else:
            self._delay_fn = DL.apply_delay
            self._delay_state = DL.init_delay_state(
                self._channels, self._delay_dmax, dtype, device=self.device)
        self._delay_vecs = self._delay_vectors()

    def _apply_delay(self, out: torch.Tensor) -> torch.Tensor:
        """The output delay on produced output [C, n], one block or several
        in a row (stateful; the output itself when no delay line is
        configured)."""
        if self._delay_fn is None:
            return out
        self._delay_state, out = self._delay_fn(self._delay_state, out,
                                                *self._delay_vecs)
        return out

    @staticmethod
    def _impulse_shared(impulse) -> bool:
        """True when every channel carries the same filter: the MAC kernels
        then read one [P, 2, Hp] coefficient plane set for all channels."""
        imp = np.asarray(impulse)
        return imp.ndim == 2 and imp.shape[0] > 1 and bool(
            (imp == imp[:1]).all())

    def _initialize(self, n_channels: int, rate: int) -> None:
        if self._channels:
            pinfo("Reinitializing filter.")
        self._pending_swap = None  # a queued crossfade is void after rebuild
        self._active = False
        self._channels = n_channels
        self._rate = rate
        stream = StreamSpec(
            n_channels=n_channels, sample_rate=rate,
            in_format=self.config.stream.in_format,
            out_format=self.config.stream.out_format,
            apply_dither=self.config.stream.apply_dither)
        try:
            built = build_chain(self.config, stream, self.cache)
        except Exception as e:  # degrade to passthrough (foo_dsp_bfir.cpp:352-357)
            pinfo("Chain build failed (%s); passing through.", e)
            return
        if built.impulse is None:
            return
        self.n_partitions = built.n_partitions
        impl = self._resolve_engine_mode()
        self._impl = impl  # the partition count rounds to the mesh's p
        fspec = self._runtime_filter_spec
        taps = fspec.n_partitions * fspec.block_length
        if impl == "nonuniform3":
            nu3 = self._nu3_geometry(fspec)
            two_stage = (nu3.p_head * nu3.block_length
                         + nu3.inner.p_head * nu3.m1)
            if taps <= two_stage:
                impl = "nonuniform"  # two stages cover it
        if impl == "nonuniform_split":
            try:
                NU.split_band_len(self._nu_geometry(fspec, impl))
            except ValueError:  # no 128-lane bands (N <= 64)
                impl = "nonuniform"
        if impl in ("nonuniform", "nonuniform_split"):
            head = self._nu_geometry(fspec, impl).p_head
            if fspec.n_partitions <= head:  # the head alone covers it
                if impl == "nonuniform_split":
                    self._channels = 0
                    raise ValueError(
                        f"filter ({taps} taps) too short for the split-tail "
                        f"engine (head alone covers "
                        f"{head * fspec.block_length})")
                impl = "hc"
        try:
            self._build_impl(impl, built, n_channels)
        except BaseException:
            self._channels = 0  # the next call builds (and fails) again
            raise
        self._keep_built(built)
        self._active = True
        pinfo("Filter length: %u samples, %u blocks.",
              fspec.block_length, fspec.n_partitions)
        pinfo("Format: %u channels, %u Hz.", n_channels, rate)

    def _build_coeffs(self, built):
        """Coefficient planes of ``built`` for the current engine, on the
        device."""
        fspec = self._runtime_filter_spec
        precise = self.config.filter.dtype == "float64"
        shared = self._impulse_shared(built.impulse)
        if self._impl == "sharded":
            return self._sharded.prepare_coeffs(built.impulse,
                                                scale=built.scale)
        if self._impl == "hc":
            return K.hc_coeffs(built.impulse, fspec, self._channels,
                               scale=built.scale, precise=precise,
                               shared=shared, device=self.device)
        if self._impl in ("nonuniform", "nonuniform_split"):
            return NU.nu_coeffs(built.impulse, self._nuspec, self._channels,
                                scale=built.scale, precise=precise,
                                shared=shared, device=self.device)
        if self._impl == "nonuniform3":
            return NU.nu3_coeffs(built.impulse, self._nuspec, self._channels,
                                 scale=built.scale, precise=precise,
                                 shared=shared, device=self.device)
        if self._impl == "packed":
            return K.pack_coeffs(built.impulse, fspec, self._channels,
                                 scale=built.scale, device=self.device)
        if self._impl == "extended":
            return E.df_coeffs(built.impulse, fspec, self._channels,
                               scale=built.scale, shared=shared,
                               device=self.device)
        return cv.coeffs_to_spectra(built.impulse, fspec, scale=built.scale,
                                    device=self.device)

    def _build_impl(self, impl: str, built, n_channels: int) -> None:
        """Coefficients, step and state for one engine, then (unless
        disabled) the known-answer self-check through that exact step."""
        self._impl = impl
        self._nu_old = None
        self._nu3_stage = None
        self._nuspec = None
        fspec = self._runtime_filter_spec
        dev = self.device
        if impl == "sharded":
            self._build_sharded(built, n_channels, fspec)
        elif impl == "nonuniform":
            nuspec = self._nu_geometry(fspec, impl)
            self._nuspec = nuspec
            # on a card each block's head step replays a CUDA graph
            self._step = NU.NuGraphStep()
            self._init_state = lambda: NU.init_nu_state(nuspec, n_channels,
                                                        device=dev)
            pinfo("Engine: non-uniform partitions (head %u x %u + tail "
                  "%u x %u, tail store %s).", nuspec.p_head,
                  nuspec.block_length, nuspec.p_tail, nuspec.m,
                  nuspec.tail_store)
        elif impl == "nonuniform_split":
            nuspec = self._nu_geometry(fspec, impl)
            NU.split_band_len(nuspec)  # geometry check (128-lane bands)
            self._nuspec = nuspec
            self._step = NU.step_nu_split
            self._init_state = lambda: NU.init_nu_split_state(
                nuspec, n_channels, device=dev)
            pinfo("Engine: non-uniform partitions, split-tail schedule "
                  "(head %u x %u + tail %u x %u, per-phase bands, tail "
                  "store %s).", nuspec.p_head, nuspec.block_length,
                  nuspec.p_tail, nuspec.m, nuspec.tail_store)
        elif impl == "nonuniform3":
            if dev.type == "cuda" and fspec.dtype == "float64":
                raise NotImplementedError(
                    "the three-stage engine's kernels store float32; float64 "
                    'on CUDA runs on engine_mode="extended" (or "auto")')
            nuspec = self._nu3_geometry(fspec)
            self._nuspec = nuspec
            self._step = NU.step_nu3
            self._init_state = lambda: NU.init_nu3_state(nuspec, n_channels,
                                                         device=dev)
            pinfo("Engine: three-stage non-uniform partitions (head %u x %u "
                  "+ mid %u x %u + far %u x %u, far store %s).",
                  nuspec.p_head, nuspec.block_length, nuspec.inner.p_head,
                  nuspec.m1, nuspec.inner.p_tail, nuspec.inner.m,
                  nuspec.inner.tail_store)
        elif impl == "hc":
            self._step = K.step_hc
            self._init_state = lambda: K.init_hc_state(fspec, n_channels,
                                                       device=dev)
        elif impl == "packed":
            if dev.type == "cuda" and fspec.dtype == "float64":
                raise NotImplementedError(
                    "the packed engine's kernel K8 stores float32; float64 "
                    'on CUDA runs on engine_mode="extended" (or "auto")')
            self._step = K.step_packed
            self._init_state = lambda: K.init_packed_state(fspec, n_channels,
                                                           device=dev)
        elif impl == "extended":
            pinfo("Engine precision: extended (native float64).")
            # on a card each block replays one CUDA graph of the step
            self._step = E.GraphStep()
            self._init_state = lambda: E.init_df_state(fspec, n_channels,
                                                       device=dev)
        else:
            self._step = cv.step
            self._init_state = lambda: cv.init_state(fspec, n_channels,
                                                     device=dev)
        self._coeffs = self._build_coeffs(built)
        if self.config.self_check:
            scaled = np.asarray(built.impulse, dtype=np.float64) * built.scale
            n_blocks, extra = 3, ""
            min_snr = selfcheck.DEFAULT_MIN_SNR_DB
            label = f"engine '{impl}'"
            kind = impl
            if impl == "sharded":
                # a fault can be mesh- or local-engine-specific: the verdict
                # does not transfer across them
                kind = self._sharded.local_impl
                label += f" ({kind})"
            if kind in ("nonuniform", "nonuniform_split", "nonuniform3"):
                nu = self._nuspec
                if kind == "nonuniform3":
                    # the far stage's first pending output has landed: the
                    # inner warm-up in M1-blocks, times r1
                    n_blocks = ((nu.inner.delay_blocks + 2) * nu.inner.ratio
                                + nu.delay_blocks) * nu.ratio1
                    store = nu.inner.tail_store
                else:
                    # the tail reaches the output only after (D + 1) fires
                    n_blocks = (nu.delay_blocks + 2) * nu.ratio
                    store = nu.tail_store
                extra = repr(nu)
                if store == "bfloat16":
                    min_snr = 35.0  # the bf16 tier's documented class
            if impl == "sharded":
                extra += f"|mesh={self._sharded.mesh.shape}|{kind}"
            with P.untraced():  # its blocks are no stream blocks
                selfcheck.check_stream(
                    self._step, self._init_state, self._coeffs, scaled,
                    fspec, n_channels, device=dev, n_blocks=n_blocks,
                    min_snr_db=min_snr, label=label,
                    cache_file=self.cache.path("selfcheck-cache.json"),
                    cache_extra=extra)
        self._init_runtime_state()

    def _build_sharded(self, built, n_channels: int,
                       fspec: FilterSpec) -> None:
        """The sharded engine over the session's mesh, its local engine
        decided from the geometry (``_sharded_local``)."""
        if self.device.type == "cuda" and fspec.dtype == "float64":
            raise NotImplementedError(
                "the sharded engine's kernels store float32; float64 on CUDA "
                'runs on engine_mode="extended" (or "auto")')
        mesh = self._resolve_mesh()
        if n_channels % mesh.shape["c"]:
            raise ValueError(f"{n_channels} channels not divisible by mesh "
                             f"c={mesh.shape['c']}")
        eng = SH.ShardedEngine(
            fspec, n_channels, mesh, local_impl=self._sharded_local(fspec),
            nu_tail_store=self._resolve_nu_tail_store("sharded"),
            shared_coeffs=self._impulse_shared(built.impulse))
        self._sharded = eng
        if eng.local_impl in ("nonuniform", "nonuniform3"):
            self._nuspec = eng.nuspec
        dev = self.device

        def step(state, coeffs, block):
            state, out = eng.step(state, coeffs, block)
            return state, out.to(dev)

        self._step = step
        self._init_state = eng.init_state
        pinfo("Engine: sharded over a %u x %u mesh (%s), local engine %s%s.",
              mesh.shape["c"], mesh.shape["p"], mesh.device_type,
              eng.local_impl, f", {eng.nuspec}" if eng.nuspec else "")

    def _sharded_local(self, fspec: FilterSpec) -> Optional[str]:
        """The sharded engine's local engine (None: the uniform default).
        ``sharded_local="auto"`` takes ``nonuniform3`` from 640 partitions
        and ``nonuniform`` from 32 on a CUDA mesh; a geometry the engine
        refuses steps down to the next, as the reference's fall-through
        does (``parallel.sharded.geometry_refusal``)."""
        want = self.config.sharded_local
        mesh = self._resolve_mesh()
        on_cuda = mesh.device_type == "cuda"
        local = None
        if want != "uniform":
            if want == "nonuniform3" or (want == "auto" and on_cuda
                                         and self.n_partitions >= 640):
                local = "nonuniform3"
            elif want == "nonuniform" or (on_cuda and self.n_partitions >= 32):
                local = "nonuniform"
        p = mesh.shape["p"]
        if local == "nonuniform3" and SH.geometry_refusal(local, fspec, p):
            local = "nonuniform"
        if local == "nonuniform" and SH.geometry_refusal(local, fspec, p):
            local = None
        return local

    def _resolve_mesh(self) -> M.Mesh:
        """The sharded engine's mesh: the one given, else every visible
        device of the session's type on the partition axis."""
        if self._mesh is None and M.process_count() > 1:
            raise ValueError(_ONE_PROCESS)
        if self._mesh is None:
            self._mesh = (M.make_mesh() if self.device.type == "cuda"
                          else M.make_mesh(devices=[self.device]))
        return self._mesh

    @property
    def _runtime_filter_spec(self) -> FilterSpec:
        """The filter spec with the partition count the chain implies
        (foo_dsp_bfir.cpp:270-272); the sharded engine rounds it up to a
        multiple of its mesh's p (zero partitions: exact output)."""
        parts = max(1, self.n_partitions)
        if self._impl == "sharded":
            p_shards = self._resolve_mesh().shape["p"]
            parts = -(-parts // p_shards) * p_shards
        return FilterSpec(block_length=self.config.filter.block_length,
                          n_partitions=parts, dtype=self.config.filter.dtype)

    def _nu_phase(self) -> int:
        """Current block phase within the tail's M-block cycle (two-stage
        engines)."""
        return self._state.head.blockcounter % self._nuspec.ratio

    def _nu3_fire_phases(self):
        """(outer fires, inner fires) for the three-stage block about to be
        stepped."""
        cnt = self._state.head.blockcounter
        r1, r2 = self._nuspec.ratio1, self._nuspec.inner.ratio
        return cnt % r1 == r1 - 1, (cnt // r1) % r2 == r2 - 1

    def _to_device(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    # -- streaming ----------------------------------------------------------

    def process(self, frames: np.ndarray,
                sample_rate: Optional[int] = None) -> np.ndarray:
        """Push ``frames`` [C, T] (engine float domain, +-1 full scale);
        returns the filtered frames of completed blocks (possibly fewer than
        T; the remainder is held until the next call). Passthrough when no
        chain is active or after a NaN abort. Thread-safe against
        ``reconfigure``."""
        with self._lock:
            return self._process_locked(frames, sample_rate)

    def _drain_inflight(self, inflight, outs, tr, keep: int = 0,
                        on_device: bool = False) -> bool:
        """Fetch stepped block outputs in order (down to ``keep`` still
        pending) with one device-to-host copy, NaN-guarding each block and
        counting a float output's overflow over the good blocks in one pass;
        ``on_device`` keeps them on the device and copies only each block's
        first sample, for the guard. Returns False on a NaN abort: the
        offending block and every later stepped block pass through as their
        raw inputs. ``tr``: the call's tracer, or None."""
        k = len(inflight) - keep
        if k <= 0:
            return True
        batch = inflight[:k]
        del inflight[:k]
        n = self.config.filter.block_length
        if tr is not None:
            tr.begin("session.fetch")
        got = torch.cat([dev for _, dev in batch], dim=1)
        if on_device:
            firsts = got[0, ::n].cpu().numpy()
        else:
            got = got.cpu().numpy()
            firsts = got[0, ::n]
        if tr is not None:
            tr.next("session.guard")
        bad = [i for i, v in enumerate(firsts.tolist())
               if not math.isfinite(v)]
        if tr is not None:
            tr.end()
        good = bad[0] if bad else k
        if good:
            y = got[:, :good * n]
            outs.append(y)
            # one count over the good blocks; a warning reads the stats
            # after each block, so then a count a block
            step = n if self.config.overflow_warnings else y.shape[1]
            for lo in range(0, y.shape[1], step):
                if self.config.stream.out_format.isfloat:
                    self._count_overflow(y[:, lo:lo + step], tr)
                if self.config.overflow_warnings:
                    self.check_overflows()
        if good == k:
            return True
        pinfo("NaN or Inf values in the system! Invalid input? Aborting.")
        self._failed = True
        outs.extend(b for b, _ in batch[good:])
        outs.extend(b for b, _ in inflight)
        inflight.clear()
        return False

    def _count_overflow(self, y: np.ndarray, tr) -> None:
        """Count the float output's fetched samples ``y`` [C, T] on the
        host, into the host partial that ``overflow_stats`` adds and the
        integer output stage folds in. ``tr``: the call's tracer, or
        None."""
        if tr is not None:
            tr.count("session.overflow_passes")
            tr.begin("session.overflow")
        if self._overflow_host is None:  # zeros like the device's
            self._overflow_host = dth.OverflowStats(*(
                torch.zeros(t.shape, dtype=t.dtype).numpy()
                for t in self._overflow))
        self._overflow_host = fm.count_float_overflow_host(
            y, self._overflow_host, out=self._abs_scratch(y))
        if tr is not None:
            tr.end()

    def _abs_scratch(self, y: np.ndarray) -> Optional[np.ndarray]:
        """An array of ``y``'s shape and dtype for its magnitudes, reused
        from drain to drain so that a drain allocates nothing; None (a
        temporary) for more samples than a drain holds."""
        width = self.MAX_INFLIGHT * self.config.filter.block_length
        if y.shape[1] > width:
            return None
        buf = self._overflow_scratch
        if buf is None or buf.dtype != y.dtype or buf.size < y.size:
            buf = self._overflow_scratch = np.empty(y.shape[0] * width,
                                                    y.dtype)
        return buf[:y.size].reshape(y.shape)

    def _fold_overflow(self) -> None:
        """Add the host partial into the device stats (the integer output
        stage reads those)."""
        part, self._overflow_host = self._overflow_host, None
        if part is None:
            return
        of = self._overflow
        self._overflow = of._replace(
            n_overflows=of.n_overflows + self._to_device(part.n_overflows),
            largest=torch.maximum(of.largest, self._to_device(part.largest)))

    def _stepped(self, block: np.ndarray, tr, special: bool = False,
                 swap=None) -> torch.Tensor:
        """``block`` copied to the device and stepped: through
        ``_special_step(swap, ...)`` when ``special``, else the engine's
        step. The output is before the delay line. ``tr``: the call's
        tracer, or None."""
        if tr is not None:
            tr.count("session.blocks")
            tr.begin("session.to_device")
        x = self._to_device(block)
        if tr is not None:
            tr.next("engine.step")
        if special:
            out = self._special_step(swap, x)
        else:
            self._state, out = self._step(self._state, self._coeffs, x)
        if tr is not None:
            tr.end()
        return out

    def _join(self, parts, on_device: bool):
        """Output parts [C, n] (device or host blocks; raw passthrough
        blocks are host arrays) joined along time, on the device when
        ``on_device``, else on the host."""
        if on_device:
            return torch.cat([p if torch.is_tensor(p) else self._to_device(p)
                              for p in parts], dim=1)
        return parts[0] if len(parts) == 1 else np.concatenate(parts, axis=1)

    def _special_step(self, swap, block: torch.Tensor) -> torch.Tensor:
        """A crossfade block: the filter change itself, or a two- or
        three-stage transition block waiting for its bridging fire."""
        if self._impl == "nonuniform3":
            # the outer head ramps now; the inner engine bridges at its next
            # step (its own ramp), its far stage at its next fire
            # (core.nonuniform.step_nu3_crossfade); the stage is tracked
            # here from the block counter
            fires, inner_fires = self._nu3_fire_phases()
            if swap is not None:
                self._pending_swap = None
                self._state, out = NU.step_nu3_crossfade(
                    self._state, self._coeffs, swap, block, head_ramp=True,
                    inner_mode="ramp")
                if fires and inner_fires:  # the whole transition in one block
                    self._nu_old = None
                else:
                    self._nu_old = self._coeffs
                    self._nu3_stage = "inner" if fires else "outer"
                self._coeffs = swap
            else:
                mode = "ramp" if self._nu3_stage == "outer" else "hold"
                self._state, out = NU.step_nu3_crossfade(
                    self._state, self._nu_old, self._coeffs, block,
                    head_ramp=False, inner_mode=mode)
                if fires and inner_fires:  # the far stage bridged: done
                    self._nu_old = None
                    self._nu3_stage = None
                elif fires:
                    self._nu3_stage = "inner"
            return out
        if self._nu_protocol():
            # the head ramps in-block now; the tail bridges at its first
            # fire after the change (core.nonuniform.step_nu_crossfade). A
            # second change before that fire keeps the tail's old side at
            # the coefficients that produced the queued pending blocks.
            ramp, hold = self._nu_xfade_steps()
            fired = self._nu_phase() == self._nuspec.ratio - 1
            if swap is not None:
                self._pending_swap = None
                old = (self._coeffs if self._nu_old is None
                       else self._nu_old._replace(head=self._coeffs.head))
                self._state, out = ramp(self._state, old, swap, block)
                self._nu_old = None if fired else old
                self._coeffs = swap
            else:
                self._state, out = hold(self._state, self._nu_old,
                                        self._coeffs, block)
                if fired:
                    self._nu_old = None
            return out.to(self.device)
        self._pending_swap = None
        xfade = (self._sharded.step_crossfade if self._impl == "sharded"
                 else {"hc": K.step_hc_crossfade,
                       "packed": K.step_packed_crossfade,
                       "extended": E.step_df_crossfade}.get(
                           self._impl, cv.step_crossfade))
        self._state, out = xfade(self._state, self._coeffs, swap, block)
        self._coeffs = swap
        return out.to(self.device)

    def _nu_protocol(self) -> bool:
        """True when the engine changes filters by the two-stage protocol
        (head ramp, then the bridging tail fire): ``nonuniform``, on one
        device or sharded."""
        return self._impl == "nonuniform" or (
            self._impl == "sharded"
            and self._sharded.local_impl == "nonuniform")

    def _nu_xfade_steps(self):
        """The two-stage protocol's (ramp, hold) steps; the sharded engine
        supplies its own pair."""
        if self._impl == "sharded":
            return self._sharded.nu_crossfade_steps()
        return (functools.partial(NU.step_nu_crossfade, head_ramp=True),
                functools.partial(NU.step_nu_crossfade, head_ramp=False))

    def _process_locked(self, frames, sample_rate=None, on_device=False):
        """``process`` under the lock; ``on_device`` returns the output as
        a tensor on the session's device instead of a host array. With a
        ``tracer``, the call is one ``session.process`` span."""
        tr = self.tracer
        if tr is None:
            return self._process_blocks(frames, sample_rate, on_device, None)
        with tr.call("session.process"):
            return self._process_blocks(frames, sample_rate, on_device, tr)

    def _process_blocks(self, frames, sample_rate, on_device, tr):
        frames = np.atleast_2d(np.asarray(frames))
        rate = sample_rate or self._rate or self.config.stream.sample_rate
        if frames.shape[0] != self._channels or rate != self._rate:
            self._initialize(frames.shape[0], rate)
        if not self._active or self._failed:
            return self._join([frames], on_device)
        n = self.config.filter.block_length
        buf = np.concatenate([self._pending,
                              frames.astype(self._pending.dtype)], axis=1)
        outs = []
        # plain blocks are stepped ahead of their fetch; outputs come back
        # in bursts, so the device-to-host copies do not stall every block.
        # A crossfade block flushes the pipeline first (an earlier NaN
        # aborts before the filter changes) and is fetched at once.
        inflight = []  # [(raw block, device out)] stepped, not fetched
        ok = True
        while ok and buf.shape[1] >= n:
            block, buf = buf[:, :n], buf[:, n:]
            swap = self._pending_swap
            special = swap is not None or self._nu_old is not None
            if special:
                ok = self._drain_inflight(inflight, outs, tr,
                                          on_device=on_device)
                if not ok:
                    break
            out = self._stepped(block, tr, special, swap)
            inflight.append((block, self._apply_delay(out)))
            if special or len(inflight) >= self.MAX_INFLIGHT:
                ok = self._drain_inflight(
                    inflight, outs, tr,
                    keep=0 if special else self.MAX_INFLIGHT // 2,
                    on_device=on_device)
        ok = ok and self._drain_inflight(inflight, outs, tr,
                                         on_device=on_device)
        self._pending = buf if ok else buf[:, :0]
        return self._join(outs or [frames[:, :0]], on_device)

    def process_buffer(self, frames: np.ndarray,
                       sample_rate: Optional[int] = None) -> np.ndarray:
        """Bulk variant of ``process``: all complete blocks in one call,
        with the two-stage engine's M-cycle step (and the sharded engine's
        macro steps) on aligned input (same outputs as the block loop). The
        partial tail is held like ``process``."""
        with self._lock:
            return self._process_buffer_locked(frames, sample_rate)

    def _process_buffer_locked(self, frames, sample_rate=None) -> np.ndarray:
        frames = np.atleast_2d(np.asarray(frames))
        rate = sample_rate or self._rate or self.config.stream.sample_rate
        if frames.shape[0] != self._channels or rate != self._rate:
            self._initialize(frames.shape[0], rate)
        if not self._active or self._failed:
            return frames
        # a queued crossfade needs the block loop
        if self._pending_swap is not None or self._nu_old is not None:
            return self._process_locked(frames, sample_rate)
        n = self.config.filter.block_length
        buf = np.concatenate([self._pending,
                              frames.astype(self._pending.dtype)], axis=1)
        n_blocks = buf.shape[1] // n
        if n_blocks == 0:
            self._pending = buf
            return frames[:, :0]
        c = buf.shape[0]
        blocks = buf[:, : n_blocks * n].reshape(c, n_blocks, n).transpose(1, 0, 2)
        self._pending = buf[:, n_blocks * n:]
        if self._impl == "sharded":
            # the engine takes its macro steps on cycle-aligned work
            self._state, outs = self._sharded.process_blocks(
                self._state, self._coeffs, self._to_device(blocks))
            outs = outs.to(self.device)
        elif self._impl in ("nonuniform", "nonuniform_split"):
            # M-cycle-aligned input takes the cycle-at-a-time scan
            aligned = (self._nu_phase() == 0
                       and n_blocks % self._nuspec.ratio == 0)
            split = self._impl == "nonuniform_split"
            if aligned:
                scan = (NU.process_blocks_nu_split if split
                        else NU.process_blocks_nu_fast)
            else:
                scan = functools.partial(
                    _scan, NU.step_nu_split if split else NU.step_nu)
            self._state, outs = scan(self._state, self._coeffs,
                                     self._to_device(blocks))
        else:
            self._state, outs = _scan(self._step, self._state, self._coeffs,
                                      self._to_device(blocks))
        y = outs.transpose(0, 1).reshape(c, -1)  # [C, B * N]
        if not np.isfinite(float(y[0, 0])):
            pinfo("NaN or Inf values in the system! Invalid input? Aborting.")
            self._failed = True
            return blocks.transpose(1, 0, 2).reshape(c, -1)
        y = self._apply_delay(y).cpu().numpy()  # delay lines take any length
        if self.config.stream.out_format.isfloat:
            self._count_overflow(y, None)
        return y

    def render(self, frames: np.ndarray,
               sample_rate: Optional[int] = None) -> np.ndarray:
        """One-shot offline render of [C, T] -> [C, T] through the bulk
        engine (core/bulk.py): the whole input exists up front, so it runs
        at the bulk geometry instead of the one-block latency schedule. The
        output is the same linear convolution the streaming engines produce
        (to float rounding); the streaming state is neither read nor
        advanced. A queued crossfade or a two- or three-stage transition
        under way (``_nu_old``; the three-stage ``_nu3_stage`` is set
        exactly then), a delay line, the ``extended`` engine (the bulk
        engine would round an honoured float64 request) or the sharded
        engine (the bulk engine runs on one device) takes
        ``process_buffer`` instead (it advances the stream, as the
        reference's fallback does), flushed so that T frames come back."""
        with self._lock:
            frames = np.atleast_2d(np.asarray(frames))
            rate = sample_rate or self._rate or self.config.stream.sample_rate
            if frames.shape[0] != self._channels or rate != self._rate:
                self._initialize(frames.shape[0], rate)
            if not self._active or self._failed:
                return frames
            if (self._pending_swap is not None or self._nu_old is not None
                    or self._delay_fn is not None
                    or self._impl in ("extended", "sharded")):
                out = self._process_buffer_locked(frames, sample_rate)
                t = frames.shape[1]
                if out.shape[1] < t:
                    n = self.config.filter.block_length
                    short = t - out.shape[1]
                    pad = np.zeros((frames.shape[0], -(-short // n) * n),
                                   dtype=out.dtype)
                    tail = self._process_buffer_locked(pad, sample_rate)
                    out = np.concatenate([out, tail], axis=1)
                return out[:, :t]
            if self._bulk is None:
                self._bulk = self._build_bulk()
            y = self._bulk.render(frames)
            if self.config.stream.out_format.isfloat and self._overflow is not None:
                self._count_overflow(y, None)
            return y

    def _build_bulk(self) -> BK.BulkRenderer:
        """The render engine for the current impulse; with ``self_check``,
        one dispatch of seeded noise through it against scipy first."""
        bulk = BK.BulkRenderer(
            self._built_impulse, self._channels, scale=self._built_scale,
            dtype=self._runtime_filter_spec.dtype, device=self.device)
        if self.config.self_check:
            scaled = self._built_impulse.astype(np.float64) * self._built_scale
            rng = np.random.default_rng(0xB01C)
            x = rng.standard_normal(
                (self._channels, bulk.samples_per_dispatch)).astype(np.float32)
            snr = selfcheck._worst_snr_db(bulk.render(x).astype(np.float64),
                                          selfcheck._oracle(x, scaled))
            if not np.isfinite(snr) or snr < selfcheck.DEFAULT_MIN_SNR_DB:
                raise selfcheck.EngineSelfCheckError(
                    f"bulk render ({bulk.engine}) known-answer check FAILED: "
                    f"worst-channel SNR {snr:.1f} dB")
            pinfo("Self-check (bulk render, %s): worst-channel SNR %.1f dB.",
                  bulk.engine, snr)
        return bulk

    def process_raw(self, raw: bytes,
                    sample_rate: Optional[int] = None) -> bytes:
        """Raw PCM in, raw PCM out: decode ``raw`` (interleaved frames of
        ``config.stream.in_format``, ``config.stream.n_channels`` channels),
        filter and delay as ``process`` does, then the output stage of
        ``out_format`` (hp-TPDF dither and error feedback when
        ``apply_dither``, else mid-tread) and encode: the
        convolver_raw2cbuf / cbuf2raw boundary (fftw_convolver.cpp:156,
        405). Returns the bytes of the completed blocks; a passthrough
        stream is still quantized to the output format. Seconds per phase
        accumulate in ``raw_seconds``."""
        stream = self.config.stream
        t0 = time.perf_counter()
        x = fm.decode(raw, stream.in_format, stream.n_channels,
                      dtype=np.dtype(self.config.filter.dtype))
        t1 = time.perf_counter()
        with self._lock:
            ofmt = self.config.stream.out_format
            # integer output stays on the device into the output stage
            y = self._process_locked(x, sample_rate,
                                     on_device=not ofmt.isfloat)
            t2 = time.perf_counter()
            if ofmt.isfloat:
                q = y
            else:
                dt = getattr(torch, self.config.filter.dtype)
                if self._overflow is None:  # passthrough before any build
                    self._overflow = dth.init_overflow_stats(
                        y.shape[0], dtype=dt, device=self.device)
                self._fold_overflow()  # counted while the output was float
                if (self.config.stream.apply_dither
                        and self._dither_state is None):
                    self._dither_state = dth.init_dither_state(
                        y.shape[0], dtype=dt, device=self.device)
                q, self._overflow, self._dither_state = fm.output_stage(
                    y.to(dt), ofmt, self._overflow, self._dither_state)
                q = q.cpu().numpy()
            t3 = time.perf_counter()
            out = (fm.encode_float(q, ofmt) if ofmt.isfloat
                   else fm.encode_int(q, ofmt))
            t4 = time.perf_counter()
            for k, dt_s in zip(self.raw_seconds,
                               (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
                self.raw_seconds[k] += dt_s
        return out

    def flush(self) -> None:
        """Drop any partial block (foo_dsp_bfir.cpp:367-370)."""
        if self._pending is not None:
            self._pending = self._pending[:, :0]

    # -- observability ------------------------------------------------------

    def overflow_stats(self) -> Optional[dth.OverflowStats]:
        """The running stats as numpy: the device's with the host
        partial added (counts sum, peaks take their maximum). Under the
        lock, so that a fold in ``process_raw`` is never seen half done."""
        with self._lock:
            if self._overflow is None:
                return None
            of = dth.OverflowStats(*(t.cpu().numpy() for t in self._overflow))
            part = self._overflow_host
        if part is None:
            return of
        return of._replace(
            n_overflows=of.n_overflows + part.n_overflows,
            largest=np.maximum(of.largest, part.largest))

    def check_overflows(self) -> None:
        """Print per-channel peak/overflow on change
        (brutefir::check_overflows + print_overflows, brutefir.cpp:370-388,
        585-629)."""
        cur = self.overflow_stats()
        if cur is None:
            return
        if any(not np.array_equal(a, b)
               for a, b in zip(cur, self._last_overflow)):
            self._last_overflow = cur
            for ch in range(self._channels):
                peak = float(cur.largest[ch])
                peak_db = 20 * np.log10(peak) if peak > 0 else -np.inf
                pinfo("Channel %d: overflows %d, peak %.2f dBFS",
                      ch, int(cur.n_overflows[ch]), peak_db)
