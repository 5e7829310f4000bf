"""Serializable collective-schedule IR for the AllReduce family.

The port's own copy of ``autodist_tpu/kernel/synchronization/
schedule_ir.py``: the same grammar, tables and error messages, over
:mod:`autodist_tpu_torch.proto.schema` in place of the protobuf enums.
The executor is :func:`autodist_tpu_torch.kernel.synchronization.
all_reduce.run_schedule`, where each phase's axis group is a
``torch.distributed`` process group (:meth:`ReplicaWorld.axis_group
<autodist_tpu_torch.parallel.mesh.ReplicaWorld.axis_group>`).

Generalizes the ``FLAT | TWO_LEVEL`` hierarchy binary into a small ordered
phase program (TACCL-style sketch, arXiv 2111.04867): each phase is
``(op, axis_group, codec)`` with ``op`` one of ``reduce_scatter``,
``all_reduce``, ``all_gather`` or ``ppermute_ring``, ``axis_group`` a subset
of the mesh's data axes, and ``codec`` a per-hop wire codec
(``AllReduceSynchronizer.Compressor`` value).  ``sync_hierarchical()`` and
flat ``psum`` are the two canonical programs of this IR
(:func:`two_level_program` / :func:`flat_program`); the executor lives in
``all_reduce.run_schedule``.

Wire format (proto field ``AllReduceSynchronizer.schedule_ir``, string 8):
``"<op>@<axis>[+<axis>...][:<codec>];..."`` — e.g. the two-level program
with an int8 DCN core and bf16 ICI hops is::

    reduce_scatter@replica_ici:BF16Compressor;
    all_reduce@replica_dcn:Int8Compressor;
    all_gather@replica_ici:BF16Compressor

Grammar (checked by :func:`validate_structure`): a prefix of
``reduce_scatter`` phases over pairwise-disjoint axis groups, an optional
single core (``all_reduce`` or ``ppermute_ring``), and a suffix of
``all_gather`` phases mirroring the scatter prefix in reverse order (same
axis groups).  The union of scatter+core axes is the set the program
reduces over — it must factor the full replica count R
(:func:`validate` with ``data_axes``).  Scatter/gather hops take only the
STATELESS elementwise codecs (none/bf16 — executed through the fused
``encode -> collective -> decode`` helper, EQuARX-style arXiv 2506.17615);
error-feedback and block codecs ride the core, and block (int8) codecs are
confined to slow hops — phases whose axis group touches a DCN-class axis
(the Y011 rule, docs/analysis.md).
"""
import dataclasses
from typing import Optional, Sequence, Tuple

from autodist_tpu_torch.const import AXIS_REPLICA_DCN
from autodist_tpu_torch.proto import schema

_AR = schema.AllReduceSynchronizer

OPS = ("reduce_scatter", "all_reduce", "all_gather", "ppermute_ring")

#: codecs legal on a scatter/gather hop: stateless elementwise only (the
#: fused wire hop has no residual slot; EF belongs on the core).
HOP_CODECS = frozenset({_AR.NoneCompressor, _AR.BF16Compressor})
#: codecs legal on an ``all_reduce`` core (the DCN-safe family).
CORE_CODECS = frozenset({_AR.NoneCompressor, _AR.BF16Compressor,
                         _AR.BF16CompressorEF, _AR.Int8Compressor,
                         _AR.Int8CompressorEF, _AR.EquarxInt8Compressor})
#: codecs legal on a ``ppermute_ring`` core: stateless cast only.
RING_CODECS = frozenset({_AR.NoneCompressor, _AR.BF16Compressor})
#: block codecs — quantize in fixed-size blocks, so the wire pays a scale
#: sidecar per block; only worth it (and only allowed) on slow hops.
BLOCK_CODECS = frozenset({_AR.Int8Compressor, _AR.Int8CompressorEF,
                          _AR.EquarxInt8Compressor})

_CODEC_NAMES = {int(c): c.name for c in _AR.Compressor}
_CODEC_VALUES = {c.name: int(c) for c in _AR.Compressor}
# short alias for the EQuARX fused codec (the paper's name); dumps() still
# emits the canonical enum name
_CODEC_VALUES["equarx_int8"] = _AR.EquarxInt8Compressor


def _codec_table() -> str:
    return ", ".join(f"{k!r} (={v})" for k, v in sorted(_CODEC_VALUES.items()))


def is_dcn_axis(name: str) -> bool:
    """Slow-hop classification: the DCN replica sub-axis (or any axis the
    mesh request tags as DCN-class by name)."""
    return name == AXIS_REPLICA_DCN or "dcn" in name


@dataclasses.dataclass(frozen=True)
class Phase:
    op: str
    axes: Tuple[str, ...]
    codec: int = 0

    @property
    def dcn(self) -> bool:
        return any(is_dcn_axis(a) for a in self.axes)


@dataclasses.dataclass(frozen=True)
class ScheduleIR:
    phases: Tuple[Phase, ...]

    def split(self):
        """``(scatter_prefix, core_or_None, gather_suffix)`` — assumes the
        program passed :func:`validate_structure`."""
        scatter = []
        core = None
        gathers = []
        for ph in self.phases:
            if ph.op == "reduce_scatter":
                scatter.append(ph)
            elif ph.op in ("all_reduce", "ppermute_ring"):
                core = ph
            else:
                gathers.append(ph)
        return tuple(scatter), core, tuple(gathers)

    @property
    def reduced_axes(self) -> Tuple[str, ...]:
        """Axes the program reduces over (scatter prefix + core), in
        program order, deduplicated."""
        out = []
        for ph in self.phases:
            if ph.op in ("reduce_scatter", "all_reduce", "ppermute_ring"):
                for a in ph.axes:
                    if a not in out:
                        out.append(a)
        return tuple(out)


def dumps(prog: ScheduleIR) -> str:
    parts = []
    for ph in prog.phases:
        s = f"{ph.op}@{'+'.join(ph.axes)}"
        if ph.codec:
            s += f":{_CODEC_NAMES[ph.codec]}"
        parts.append(s)
    return ";".join(parts)


def _parse_codec(tok: str, phase_text: str) -> int:
    tok = tok.strip()
    if tok in _CODEC_VALUES:
        return _CODEC_VALUES[tok]
    try:
        v = int(tok)
    except ValueError:
        raise ValueError(
            f"Unknown codec {tok!r} in schedule_ir phase {phase_text!r}; "
            f"accepted names/values: {_codec_table()}") from None
    if v not in _CODEC_NAMES:
        raise ValueError(
            f"Unknown codec enum value {v} in schedule_ir phase "
            f"{phase_text!r}; accepted names/values: {_codec_table()}")
    return v


def loads(text: str) -> ScheduleIR:
    """Parse the wire format.  Raises ``ValueError`` with the accepted
    op/codec tables on unknown tokens; structural legality is checked
    separately by :func:`validate_structure` / :func:`validate`."""
    phases = []
    for raw in str(text).split(";"):
        part = raw.strip()
        if not part:
            continue
        codec = 0
        head, sep, tail = part.partition(":")
        if sep:
            codec = _parse_codec(tail, part)
        op, sep, axes_text = head.partition("@")
        op = op.strip()
        if op not in OPS:
            raise ValueError(
                f"Unknown op {op!r} in schedule_ir phase {part!r}; accepted "
                f"ops: {', '.join(repr(o) for o in OPS)}")
        if not sep:
            raise ValueError(
                f"schedule_ir phase {part!r} is missing '@<axis>' — expected "
                f"'<op>@<axis>[+<axis>...][:<codec>]'")
        axes = tuple(a.strip() for a in axes_text.split("+") if a.strip())
        if not axes:
            raise ValueError(
                f"schedule_ir phase {part!r} names no mesh axes")
        phases.append(Phase(op=op, axes=axes, codec=codec))
    if not phases:
        raise ValueError("schedule_ir is empty — expected at least one "
                         "'<op>@<axis>[:<codec>]' phase")
    return ScheduleIR(phases=tuple(phases))


def validate_structure(prog: ScheduleIR) -> None:
    """Grammar + codec-family legality (mesh-free): scatter* core? gather*,
    gathers mirroring scatters in reverse, disjoint scatter groups, hop
    codecs stateless.  Raises ``ValueError`` (the Y010 class)."""
    scatter, core, gathers = [], None, []
    stage = 0  # 0=scatter prefix, 1=core seen, 2=gather suffix
    for ph in prog.phases:
        if ph.op == "reduce_scatter":
            if stage != 0:
                raise ValueError(
                    f"schedule_ir: reduce_scatter@{'+'.join(ph.axes)} after "
                    f"the core/gather — programs are 'reduce_scatter* "
                    f"(all_reduce|ppermute_ring)? all_gather*'")
            scatter.append(ph)
        elif ph.op in ("all_reduce", "ppermute_ring"):
            if stage != 0 or core is not None:
                raise ValueError(
                    f"schedule_ir: more than one core phase or core after "
                    f"all_gather ({ph.op}@{'+'.join(ph.axes)})")
            core = ph
            stage = 1
        else:  # all_gather
            stage = 2
            gathers.append(ph)
    seen = set()
    for ph in scatter:
        if seen & set(ph.axes):
            raise ValueError(
                f"schedule_ir: reduce_scatter phases must use pairwise-"
                f"disjoint axis groups; {'+'.join(ph.axes)} repeats an axis")
        seen |= set(ph.axes)
        if core is not None and seen & set(core.axes):
            raise ValueError(
                f"schedule_ir: core axes {'+'.join(core.axes)} overlap a "
                f"reduce_scatter phase's axes")
    if len(gathers) != len(scatter) or any(
            g.axes != s.axes for g, s in zip(gathers, reversed(scatter))):
        want = [f"all_gather@{'+'.join(s.axes)}" for s in reversed(scatter)]
        raise ValueError(
            f"schedule_ir: the all_gather suffix must mirror the "
            f"reduce_scatter prefix in reverse order — expected "
            f"[{'; '.join(want)}]")
    if core is None and not scatter:
        raise ValueError("schedule_ir reduces over no axes — need a "
                         "reduce_scatter prefix and/or a core phase")
    for ph in scatter + gathers:
        if ph.codec not in HOP_CODECS:
            names = ", ".join(sorted(_CODEC_NAMES[c] for c in HOP_CODECS))
            raise ValueError(
                f"schedule_ir: codec {_CODEC_NAMES.get(ph.codec, ph.codec)} "
                f"is not legal on a {ph.op} hop — scatter/gather hops take "
                f"only the stateless elementwise codecs ({names}); "
                f"error-feedback and block codecs ride the core phase")
    if core is not None:
        legal = RING_CODECS if core.op == "ppermute_ring" else CORE_CODECS
        if core.codec not in legal:
            names = ", ".join(sorted(_CODEC_NAMES[c] for c in legal))
            raise ValueError(
                f"schedule_ir: codec "
                f"{_CODEC_NAMES.get(core.codec, core.codec)} is not legal "
                f"on a {core.op} core; accepted: {names}")
        if core.op == "ppermute_ring" and len(core.axes) != 1:
            raise ValueError(
                f"schedule_ir: ppermute_ring runs over exactly one mesh "
                f"axis, got {'+'.join(core.axes)}")


def block_codec_violations(prog: ScheduleIR):
    """Phases carrying a block (int8) codec on a fast (non-DCN) hop — the
    Y011 rule: block quantization only pays for itself across the slow
    wire, and the fast-hop phases must stay exactly invertible."""
    return [ph for ph in prog.phases
            if ph.codec in BLOCK_CODECS and not ph.dcn]


def validate(prog: ScheduleIR, data_axes: Optional[Sequence[str]] = None,
             axis_sizes: Optional[dict] = None) -> None:
    """Full well-formedness: structure, block-codec placement, and — when
    the mesh is known — that the reduced axes exactly cover ``data_axes``
    (so the program factors R) and every named axis exists."""
    validate_structure(prog)
    bad = block_codec_violations(prog)
    if bad:
        ph = bad[0]
        raise ValueError(
            f"schedule_ir: block codec {_CODEC_NAMES[ph.codec]} on fast hop "
            f"{ph.op}@{'+'.join(ph.axes)} — block codecs are confined to "
            f"phases whose axis group includes a DCN-class axis")
    for ph in prog.phases:
        if len(set(ph.axes)) != len(ph.axes):
            # the grammar's disjointness check dedups axes WITHIN a
            # phase, but a repeated axis inflates the phase's rendezvous
            # group size past the ranks that exist — the L004 deadlock
            raise ValueError(
                f"schedule_ir: phase {ph.op}@{'+'.join(ph.axes)} repeats "
                f"a mesh axis — each axis may appear once per phase (a "
                f"duplicate inflates the rendezvous group past the "
                f"existing ranks and the collective deadlocks)")
    if axis_sizes is not None:
        for ph in prog.phases:
            for a in ph.axes:
                if a not in axis_sizes:
                    raise ValueError(
                        f"schedule_ir names mesh axis {a!r} which the mesh "
                        f"does not define; mesh axes: "
                        f"{', '.join(sorted(axis_sizes))}")
    if data_axes is not None:
        reduced = set(prog.reduced_axes)
        expected = set(data_axes)
        if reduced != expected:
            raise ValueError(
                f"schedule_ir reduces over {sorted(reduced)} but the data "
                f"axes are {sorted(expected)} — the scatter prefix + core "
                f"must factor the full replica count R")


def flat_program(axes: Sequence[str], codec: int = 0) -> ScheduleIR:
    """The canonical FLAT program: one all_reduce core over all data axes."""
    return ScheduleIR(phases=(
        Phase(op="all_reduce", axes=tuple(axes), codec=codec),))


def two_level_program(ici: str, dcn: Sequence[str],
                      codec: int = 0) -> ScheduleIR:
    """The canonical TWO_LEVEL program: ICI reduce-scatter, DCN core with
    the (dcn_)codec, ICI all-gather — ``sync_hierarchical()`` as IR."""
    return ScheduleIR(phases=(
        Phase(op="reduce_scatter", axes=(ici,)),
        Phase(op="all_reduce", axes=tuple(dcn), codec=codec),
        Phase(op="all_gather", axes=(ici,)),
    ))


def canonical_hierarchy(prog: ScheduleIR) -> Optional[int]:
    """``_AR.FLAT`` / ``_AR.TWO_LEVEL`` when the program is shape-identical
    to a legacy hierarchy (so the engine can run the battle-tested legacy
    path, incl. sharded-update composition); ``None`` for genuinely
    searched programs."""
    scatter, core, gathers = prog.split()
    if not scatter and core is not None and core.op == "all_reduce":
        return _AR.FLAT
    if (len(scatter) == 1 and core is not None and core.op == "all_reduce"
            and len(scatter[0].axes) == 1
            and scatter[0].codec == 0 and gathers[0].codec == 0):
        return _AR.TWO_LEVEL
    return None


def core_codec(prog: ScheduleIR) -> int:
    """The codec riding the core phase (0 = NoneCompressor when the
    program has no core) — sizes EF residual state for the executor."""
    _, core, _ = prog.split()
    return core.codec if core is not None else 0


def phase_group_size(ph: Phase, axis_sizes: dict) -> int:
    n = 1
    for a in ph.axes:
        n *= int(axis_sizes.get(a, 1))
    return n
