"""The loop-carried dependency chain of a walker kernel, read off its SASS.

    python3 -m satdump_tpu_torch.tools.sass_chain <lib.so | sass.txt>
        [--function SUBSTRING] [--latency latency.json]

A walker kernel (csrc/sample_walk.cu, csrc/mm_clock.cu) walks its samples
one after another on one thread: each step waits for the state that the step
before it left. So the kernel takes at least the cycles of that chain times
its steps. This module reads the chain off `cuobjdump -sass`:

 * the walk loop is the function's largest loop (a backward branch) with no
   barrier in it, outside the subroutines it calls (the PLL walks phases not
   known to stay in range in one); its steps a pass are its 8-byte stores
   (one output a step);
 * an instruction that writes no scoreboard (fixed latency) takes the
   fewest issue cycles (stall counts) that the compiler put between such an
   instruction and the first one that reads its result, anywhere in the
   functions read; one that writes a scoreboard (a conversion, MUFU, a shared
   load) takes the latency measured on the card (tools/op_latency.cu), or,
   where none was measured, the smallest fixed latency;
 * the loop's body is walked once, block by block in address order, with
   the back edges inside it dropped. For each register at the top of the
   body it tracks the longest dependency path to each register at the
   bottom. Where paths join it keeps the shorter, and a predicated
   instruction may not have run, so the chain holds on every path that
   the walk's data can take. A way on which a carried value turns
   constant does not count there: that is special-value handling (zero,
   infinity, NaN; a product with the zero register RZ, 0 x a finite value)
   that a recurrence's finite data never takes, and neither does a way
   through a CALL (nvcc's slow path of __fdiv_rn and __fsqrt_rn, for zero,
   subnormal, huge or special operands). Memory dependencies,
   control dependencies and issue limits are left out. So the result is a
   lower bound on the loop's time on such data;
 * a walk loop that moves values through local memory (LDL / STL: the
   state spilled, or its address taken) is refused, since the chain is
   read through registers;
 * the chain's cycles a pass are the largest cycle mean of that
   register-to-register matrix (max-plus), divided by the steps a pass.
   Beside it, the stall cycles a step: the fewest issue cycles the compiler's
   schedule (the stall counts) gives a pass along any path, over the steps,
   with no wait on a scoreboard counted. One warp can go no faster either.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

_INS_RE = re.compile(
    r"/\*([0-9a-f]{4,})\*/\s+([^;\n]*?)\s*;\s*/\*\s*0x[0-9a-f]{16}\s*\*/"
    r"\s*\n\s*/\*\s*(0x[0-9a-f]{16})\s*\*/")
_REG_RE = re.compile(r"(?<![A-Za-z0-9_])(UR\d+|UP\d|R\d+|P\d)(\.64)?"
                     r"(?![0-9])")
_GUARD_RE = re.compile(r"^@!?(U?P[T0-9])\s+")
# opcodes that write no register
_NO_DST = {"ST", "STS", "STG", "STL", "BRA", "BRX", "JMP", "BAR", "EXIT",
           "RET", "CALL", "BSSY", "BSYNC", "NOP", "WARPSYNC", "RED",
           "MEMBAR", "DEPBAR", "ERRBAR", "CCTL", "YIELD", "BPT", "KILL",
           "LDGDEPBAR", "ARRIVES", "SYNCS", "BREAK"}
# opcodes whose first two operands are written (predicate pairs)
_TWO_DST = {"FSETP", "ISETP", "DSETP", "HSETP2", "PLOP3", "UISETP",
            "UPLOP3", "VOTE"}
_FP64 = {"DADD", "DMUL", "DFMA", "DMNMX", "DSETP", "DSET"}
# products whose two first sources are the factors
_PRODUCTS = {"FMUL", "DMUL", "FFMA", "DFMA"}
# a SASS walk loop of this repo stores one 8-byte output a step
_STEP_STORES = ("STS.64", "STG.E.64")


@dataclass
class Ins:
    addr: int
    text: str
    op: str                       # opcode with its modifiers
    guard: Optional[str]          # a control dependence: not in srcs
    dsts: List[str]
    srcs: List[str]
    target: Optional[int]         # a branch's target address
    stall: int                    # issue cycles to the next instruction
    scoreboard: bool              # writes a scoreboard: variable latency

    @property
    def mnemonic(self) -> str:
        return self.op.split(".")[0]

    @property
    def branch(self) -> bool:
        return self.mnemonic in ("BRA", "BRX", "JMP")


def _split_operands(s: str) -> List[str]:
    return [o.strip() for o in s.split(",")] if s.strip() else []


def _widen(reg: str, width: int) -> List[str]:
    m = re.fullmatch(r"(U?R)(\d+)", reg)
    if width == 1 or m is None:
        return [reg]
    return [f"{m.group(1)}{int(m.group(2)) + i}" for i in range(width)]


def _regs(operand: str, width: int) -> List[str]:
    out = []
    for name, w64 in _REG_RE.findall(operand):
        out += _widen(name, 2 if w64 else (1 if "[" in operand else width))
    return out


def _dst_width(mn: str, mods: List[str]) -> int:
    if mn in _FP64:
        return 2
    if mn in ("F2F", "I2F"):
        return 2 if mods and mods[0] == "F64" else 1
    if mn == "F2I":
        return 2 if {"S64", "U64"} & set(mods) else 1
    if mn == "FRND":
        return 2 if "F64" in mods else 1
    if "128" in mods:
        return 4
    if {"64", "WIDE"} & set(mods) or mn == "CS2R":
        return 2
    return 1


def _src_width(mn: str, mods: List[str], k: int, nsrc: int) -> int:
    if mn in _FP64:
        return 2
    if mn == "F2F":
        return 2 if len(mods) > 1 and mods[1] == "F64" else 1
    if mn in ("F2I", "FRND"):
        return 2 if "F64" in mods else 1
    if mn == "I2F":
        return 2 if {"S64", "U64"} & set(mods) else 1
    if mn == "IMAD" and "WIDE" in mods:
        return 2 if k == 2 else 1
    if mn in ("STS", "STG", "STL", "ST") and k == nsrc - 1:
        return 4 if "128" in mods else 2 if "64" in mods else 1
    return 1


def _parse_ins(addr: int, text: str, hi: int) -> Ins:
    guard = None
    g = _GUARD_RE.match(text)
    if g:
        guard = g.group(1)
        text = text[g.end():]
    op, _, rest = text.partition(" ")
    mn, *mods = op.split(".")
    operands = _split_operands(rest)
    target = None
    if mn in ("BRA", "CALL", "BSSY") and operands:
        t = re.search(r"0x[0-9a-f]+", operands[-1])
        target = int(t.group(0), 16) if t else None
    ndst = 0
    if mn not in _NO_DST and operands:
        ndst = 2 if mn in _TWO_DST or (mn in ("LOP3", "ULOP3") and
                                       re.fullmatch(r"U?P[T0-9]",
                                                    operands[0])) else 1
        # a carry out: IADD3 R21, P1, ... / LEA R4, P0, ...
        while (ndst < len(operands) and mn in ("IADD3", "LEA", "IMAD", "SHF",
                                               "UIADD3", "ULEA")
               and re.fullmatch(r"U?P[T0-9]", operands[ndst])):
            ndst += 1
    dsts, srcs = [], []
    width = _dst_width(mn, mods)
    for o in operands[:ndst]:
        dsts += _regs(o, width if o.startswith(("R", "UR")) else 1)
    src_ops = operands[ndst:]
    if mn in _PRODUCTS and any(o.strip("-|").split(".")[0] == "RZ"
                               for o in src_ops[:2]):
        src_ops = src_ops[2:]     # 0 x (finite) is 0: only the addend counts
    for k, o in enumerate(src_ops):
        srcs += _regs(o, _src_width(mn, mods, k, len(src_ops)))
    ctl = hi >> 41
    return Ins(addr=addr, text=text, op=op, guard=guard,
               dsts=[d for d in dsts if d not in ("PT", "UPT")],
               srcs=[s for s in srcs if s not in ("PT", "UPT")],
               target=target, stall=ctl & 0xF,
               scoreboard=((ctl >> 5) & 7) != 7)


@dataclass
class Function:
    name: str
    ins: List[Ins] = field(default_factory=list)


def parse_sass(text: str) -> List[Function]:
    """The functions of `cuobjdump -sass` output, each a list of parsed
    instructions."""
    funcs = []
    for chunk in re.split(r"\n\s*Function : ", text)[1:]:
        name = chunk.split("\n", 1)[0].strip()
        f = Function(name)
        for addr, body, hi in _INS_RE.findall(chunk):
            f.ins.append(_parse_ins(int(addr, 16), body.strip(),
                                    int(hi, 16)))
        funcs.append(f)
    return funcs


def _leaders(ins: List[Ins]) -> set:
    """Indices that start a basic block."""
    at = {x.addr: i for i, x in enumerate(ins)}
    lead = {0}
    for i, x in enumerate(ins):
        if x.branch or x.mnemonic in ("EXIT", "RET", "CALL"):
            lead.add(i + 1)
            if x.branch and x.target in at:
                lead.add(at[x.target])
    return lead


def _key(x: Ins) -> str:
    """The opcode without the modifiers that do not change its latency
    (comparisons, rounding of integers, .reuse and the like)."""
    mn, *mods = x.op.split(".")
    keep = [m for m in mods if m in ("F64", "F32", "F16", "64", "128", "WIDE",
                                     "RCP64H", "RSQ64H", "RCP", "RSQ", "SIN",
                                     "COS", "EX2", "LG2", "SQRT", "S64",
                                     "U64")]
    return ".".join([mn, *keep])


def fixed_latencies(funcs: List[Function]) -> Dict[str, int]:
    """For each fixed-latency opcode key, the fewest issue cycles between an
    instruction and the first later one in its block that reads its
    result, over every such pair in `funcs`."""
    best: Dict[str, int] = {}
    for f in funcs:
        ins = f.ins
        lead = sorted(_leaders(ins) | {len(ins)})
        for b0, b1 in zip(lead, lead[1:]):
            for i in range(b0, b1):
                p = ins[i]
                if p.scoreboard or p.branch or not p.dsts:
                    continue
                for r in p.dsts:
                    dist = 0
                    for j in range(i + 1, b1):
                        dist += ins[j - 1].stall
                        if r in ins[j].srcs:
                            k = _key(p)
                            best[k] = min(best.get(k, dist), dist)
                            break
                        if r in ins[j].dsts and ins[j].guard is None:
                            break
    return best


class Latency:
    """Cycles from an instruction's issue to its result's first use."""

    def __init__(self, fixed: Dict[str, int], measured: Dict[str, float]):
        self.fixed, self.measured = fixed, measured
        self.floor = min(fixed.values()) if fixed else 1
        self.unmeasured: Dict[str, int] = {}

    def __call__(self, x: Ins) -> float:
        """The smaller of the stall-count figure (a fixed-latency
        instruction only) and the measured one, where there are both."""
        k = _key(x)

        def first(table):
            return next((float(table[c]) for c in (k, x.mnemonic)
                         if c in table), None)
        got = [v for v in (first(self.measured),
                           None if x.scoreboard else first(self.fixed))
               if v is not None]
        if not got:
            if x.scoreboard:
                self.unmeasured[k] = self.unmeasured.get(k, 0) + 1
            return float(self.floor)
        return min(got)


def step_loops(f: Function, step_store: str) -> List[Tuple[int, int]]:
    """(first, last) instruction index of each innermost loop with no
    barrier in it, outside the subroutines f calls, that holds a
    `step_store` (an opcode with its modifiers): the per-step loops of a
    kernel that walks in more than one loop (csrc/turbo_bcjr.cu's forward
    and backward recursions), in address order."""
    at = {x.addr: i for i, x in enumerate(f.ins)}
    called = [range(i, j + 1) for i, j in _subroutines(f)]
    loops = []
    for i, x in enumerate(f.ins):
        if x.branch and x.target is not None and x.target <= x.addr \
                and x.target in at:
            j = at[x.target]
            body = f.ins[j:i + 1]
            if any(y.mnemonic == "BAR" for y in body) or \
                    any(i in r for r in called) or \
                    not any(y.op == step_store for y in body):
                continue
            loops.append((j, i))
    inner = [a for a in loops if not any(b != a and a[0] <= b[0] and
                                         b[1] <= a[1] for b in loops)]
    return sorted(inner)


def walk_loop(f: Function) -> Tuple[int, int]:
    """(first, last) instruction index of the largest loop with no barrier
    in it outside the subroutines f calls: the walker's per-step loop."""
    at = {x.addr: i for i, x in enumerate(f.ins)}
    called = [range(i, j + 1) for i, j in _subroutines(f)]
    best = None
    for i, x in enumerate(f.ins):
        if x.branch and x.target is not None and x.target <= x.addr \
                and x.target in at:
            j = at[x.target]
            if any(y.mnemonic == "BAR" for y in f.ins[j:i + 1]) or \
                    any(i in r for r in called):
                continue
            if best is None or i - j > best[1] - best[0]:
                best = (j, i)
    if best is None:
        raise ValueError(f"{f.name}: no loop without a barrier")
    return best


_Path = Tuple[float, Optional[tuple]]     # (cycles, chain as a cons list)


def _get(state: dict, r: str) -> Dict[str, _Path]:
    v = state.get(r)
    return {r: (0.0, None)} if v is None else v


def _join(vs: List[Dict[str, _Path]]) -> Dict[str, _Path]:
    """One register's paths where ways meet: those that hold on every way
    that carries the register's dependence, each the shortest. A way on
    which the value is a constant (special-value handling) is left out."""
    live = [v for v in vs if v]
    if not live:
        return {}
    heads = set(live[0]).intersection(*live[1:])
    return {h: min((v[h] for v in live), key=lambda p: p[0]) for h in heads}


def _merge(states: List[dict], cold: List[bool]) -> dict:
    """The state where ways meet; ways through a CALL (cold) are left out
    where another way arrives."""
    if not all(cold):
        states = [s for s, c in zip(states, cold) if not c]
    if len(states) == 1:
        return dict(states[0])
    return {r: _join([_get(s, r) for s in states])
            for r in set().union(*states)}


def chain(f: Function, lat: Latency, loop: Optional[Tuple[int, int]] = None,
          step_store: Optional[str] = None, stores_a_step: int = 1) -> dict:
    """The loop-carried chain of f's walk loop (or of `loop`, from
    step_loops): cycles a pass and a step, steps a pass, and the opcodes
    along the longest one-pass cycle. A step is one 8-byte store, or
    `stores_a_step` stores of the opcode `step_store` where one is
    given."""
    j0, j1 = loop or walk_loop(f)
    body = f.ins[j0:j1 + 1]
    spill = [x.text for x in body if x.mnemonic in ("LDL", "STL")]
    if spill:
        raise ValueError(f"{f.name}: the walk loop moves values through "
                         f"local memory ({spill[:2]}), which a register "
                         f"chain misses")
    at = {x.addr: i for i, x in enumerate(body)}
    lead = sorted({i for i in _leaders(body) if i < len(body)})
    ends = dict(zip(lead, lead[1:] + [len(body)]))
    incoming: Dict[int, List[dict]] = {0: [{}]}
    cold_in: Dict[int, List[bool]] = {0: [False]}
    issue_in: Dict[int, List[Tuple[bool, int]]] = {0: [(False, 0)]}
    end_state = end_issue = None
    for b in lead:
        if b not in incoming:
            continue                  # reached only by a dropped back edge
        arrivals = cold_in.pop(b)
        state = _merge(incoming.pop(b), arrivals)
        # a way through a CALL (nvcc's slow path of a division or a square
        # root, for special operands) stays cold until it meets another
        cold = all(arrivals) or any(x.mnemonic == "CALL"
                                    for x in body[b:ends[b]])
        ways = issue_in.pop(b)
        issue = min(c for k, c in ways if k == all(arrivals)) + \
            sum(x.stall for x in body[b:ends[b]])
        for i in range(b, ends[b]):
            x = body[i]
            paths: Dict[str, _Path] = {}
            for s in x.srcs:
                for h, (c, ch) in _get(state, s).items():
                    if h not in paths or c > paths[h][0]:
                        paths[h] = (c, ch)
            if x.dsts:
                d = lat(x)
                new = {h: (c + d, (i, ch)) for h, (c, ch) in paths.items()}
                for r in x.dsts:
                    if x.guard is None:
                        state[r] = new
                    else:                 # it may not have run
                        state[r] = _join([_get(state, r), new])
        last = body[ends[b] - 1]
        succ = []
        if not (last.branch and last.guard is None) and \
                last.mnemonic not in ("EXIT", "RET"):
            succ.append(ends[b])
        if last.branch and last.target in at and at[last.target] > b:
            succ.append(at[last.target])
        if ends[b] == len(body):
            end_state, end_issue = state, issue
            continue
        for s in succ:
            if s < len(body):
                incoming.setdefault(s, []).append(state)
                cold_in.setdefault(s, []).append(cold)
                issue_in.setdefault(s, []).append((cold, issue))
    if end_state is None:
        raise ValueError(f"{f.name}: the walk loop's end is not reached")
    regs = sorted({r for r, v in end_state.items() if v})
    idx = {r: k for k, r in enumerate(regs)}
    n = len(regs)
    a = np.full((n, n), -np.inf)
    for s in regs:
        for h, (c, _) in end_state[s].items():
            if h in idx:
                a[idx[h], idx[s]] = max(a[idx[h], idx[s]], c)
    # the largest cycle mean: max over k <= n of the max diagonal of A^k / k
    best, p = -np.inf, a.copy()
    for k in range(1, n + 1):
        best = max(best, float(np.max(np.diag(p))) / k)
        if k < n:
            p = np.max(p[:, :, None] + a[None, :, :], axis=1)
    if step_store is None:
        steps = sum(1 for x in body if x.op.startswith(_STEP_STORES))
    else:
        steps = sum(1 for x in body if x.op == step_store) / stores_a_step
    if steps == 0 or not np.isfinite(best):
        raise ValueError(f"{f.name}: no step stores or no carried chain")
    # the one-pass self cycle with the most cycles, for its opcodes
    r_top = max(regs, key=lambda r: end_state[r].get(r, (-np.inf,))[0])
    ops, link = [], end_state[r_top].get(r_top, (0, None))[1]
    while link is not None:
        ops.append(_key(body[link[0]]))
        link = link[1]
    hist: Dict[str, int] = {}
    for o in ops:
        hist[o] = hist.get(o, 0) + 1
    return {"function": f.name, "loop": [body[0].addr, body[-1].addr],
            "instructions_a_pass": len(body), "steps_a_pass": steps,
            "cycles_a_pass": best, "cycles_a_step": best / steps,
            "stall_cycles_a_step": end_issue / steps,
            "chain_register": r_top, "chain_opcodes": hist,
            "unmeasured": dict(lat.unmeasured)}


def fp64_instructions(f: Function) -> List[Ins]:
    """f's float64 instructions: arithmetic and compares on doubles, the
    double-precision MUFU seeds and every conversion to or from a double."""
    out = []
    for x in f.ins:
        mn, *mods = x.op.split(".")
        if mn in _FP64 or (mn == "MUFU" and any(m.endswith("64H")
                                                for m in mods)) or \
                (mn in ("F2F", "F2I", "I2F", "FRND") and "F64" in mods):
            out.append(x)
    return out


def _zero_factor(x: Ins) -> bool:
    """An FFMA one of whose factors is the zero register: it adds, and
    rounds nothing that an FADD would not."""
    return any(o.strip().lstrip("-|").split(".")[0] == "RZ"
               for o in _split_operands(x.text.partition(" ")[2])[1:3])


def _subroutines(f: Function) -> List[Tuple[int, int]]:
    """(first, last) instruction index of each subroutine that f CALLs:
    from the call's target to the first RET after it."""
    at = {x.addr: i for i, x in enumerate(f.ins)}
    out = []
    for t in sorted({x.target for x in f.ins if x.mnemonic == "CALL"
                     and x.target in at}):
        i = at[t]
        j = next((k for k in range(i, len(f.ins))
                  if f.ins[k].mnemonic == "RET"), len(f.ins) - 1)
        out.append((i, j))
    return out


def _seed(x: Ins) -> bool:
    """A float32 MUFU.RCP or MUFU.RSQ: the seed of nvcc's correctly
    rounded division or square root."""
    return x.op.split(".")[:2] in (["MUFU", "RCP"], ["MUFU", "RSQ"])


def rounding_ffma(f: Function) -> Tuple[List[Ins], int]:
    """(the FFMAs of f that round a product into a sum outside nvcc's own
    correctly rounded division and square root, how many FFMAs lie inside
    those). An FFMA with a zero factor (RZ) adds and rounds nothing more;
    every other FFMA is inside where
     * it reads, directly or through other float products, sums and
       moves, the result of a MUFU.RCP or MUFU.RSQ (the seed of __fdiv_rn's
       or __fsqrt_rn's Newton steps), before the BSYNC where that
       sequence's fast way meets its slow one (a window read in address
       order, so a register once reached stays reached until that BSYNC:
       the slow way may overwrite it before the fast way, laid out after
       it, reads it); the code that uses the quotient or the root after
       that point is outside, or
     * it lies in a subroutine CALLed between such a seed and its BSYNC:
       the sequence's slow path, for special operands."""
    subs = dict((f.ins[i].addr, (i, j)) for i, j in _subroutines(f))

    def scan(slow: set):
        seeded: set = set()
        rounding, inside, calls = [], 0, set()
        for k, x in enumerate(f.ins):
            mn = x.mnemonic
            if mn == "BSYNC":
                seeded.clear()
                continue
            if mn == "CALL" and seeded and x.target in subs:
                calls.add(x.target)
            fed = any(r in seeded for r in x.srcs)
            if mn == "FFMA" and not _zero_factor(x):
                if fed or k in slow:
                    inside += 1
                else:
                    rounding.append(x)
            if _seed(x) or (fed and (mn in ("FFMA", "FMUL", "FADD", "MOV")
                                     or x.op.startswith("IMAD.MOV"))):
                seeded.update(x.dsts)
        return rounding, inside, calls

    # the windows do not depend on the slow paths: find those, then count
    slow = set()
    for t in scan(set())[2]:
        slow.update(range(subs[t][0], subs[t][1] + 1))
    rounding, inside, _ = scan(slow)
    return rounding, inside


def cuobjdump_sass(lib: Path) -> str:
    """`cuobjdump -sass` of a built library or program, with the toolkit's
    cuobjdump (beside nvcc)."""
    from satdump_tpu_torch.ops.cuda import _build
    tool = Path(_build.nvcc_path()).with_name("cuobjdump")
    return subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout


LATENCY_SRC = Path(__file__).with_name("op_latency.cu")
LATENCY_STEPS = 512                 # op_latency.cu's kSteps
# each test of op_latency.cu and the opcode key whose latency it prints
LATENCY_TESTS = {
    "lat_rcp": "MUFU.RCP", "lat_rsq": "MUFU.RSQ", "lat_fadd": "FADD",
    "lat_dadd": "DADD", "lat_f2f_f64_f32": "F2F.F64.F32",
    "lat_f2f_round_trip": "F2F.F32.F64", "lat_f2i": "F2I", "lat_i2f": "I2F",
    "lat_frnd": "FRND", "lat_f2i_f64": "F2I.F64", "lat_i2f_f64": "I2F.F64",
    "lat_rcp64h": "MUFU.RCP64H", "lat_rsq64h": "MUFU.RSQ64H",
    "lat_lds": "LDS", "lat_lds64": "LDS.64", "lat_shfl": "SHFL",
    "lat_redux": "REDUX"}


def latency_program() -> Path:
    """Where op_latency.cu's program is built (the build directory of the
    port's kernels; the name carries a hash of the source and flags)."""
    import hashlib
    from satdump_tpu_torch.ops.cuda import _build
    h = hashlib.sha256(LATENCY_SRC.read_bytes()
                       + " ".join(_build.NVCC_FLAGS[:2]).encode())
    return _build.BUILD_DIR / f"op_latency-{h.hexdigest()[:12]}"


def start_latency_build() -> Optional[subprocess.Popen]:
    """Start nvcc on op_latency.cu unless it is built; None if it is."""
    from satdump_tpu_torch.ops.cuda import _build
    exe = latency_program()
    if exe.exists():
        return None
    exe.parent.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS[:2], "-O3", "-o",
         str(exe.with_suffix(".tmp")), str(LATENCY_SRC)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def finish_latency_build(proc: Optional[subprocess.Popen]) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for op_latency.cu:\n{log}")
    exe = latency_program()
    exe.with_suffix(".tmp").replace(exe)


def measured_latencies() -> Tuple[Dict[str, float], Dict[str, float]]:
    """Runs op_latency.cu's program on the card (built first if needed):
    (the latencies whose test's SASS holds the instruction it names at
    every step and little else, the others)."""
    if not latency_program().exists():
        finish_latency_build(start_latency_build())
    exe = latency_program()
    out = subprocess.run([str(exe)], capture_output=True, text=True,
                         check=True, timeout=120).stdout
    vals = json.loads(out.strip().splitlines()[-1])
    funcs = {f.name: f for f in parse_sass(cuobjdump_sass(exe))}
    kept, dropped = {}, {}
    for fname, key in LATENCY_TESTS.items():
        f = funcs.get(fname)
        # the timed instruction at every step, and little else
        ok = f is not None and LATENCY_STEPS <= sum(
            _key(x) == key for x in f.ins) and len(f.ins) <= 3 * \
            LATENCY_STEPS + 64
        (kept if ok else dropped)[key] = vals[key]
    return kept, dropped


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("src", help="a built library (.so) or saved SASS text")
    ap.add_argument("--function", default="", help="a substring of the name")
    ap.add_argument("--latency", help="JSON of measured latencies by opcode")
    args = ap.parse_args()
    src = Path(args.src)
    text = cuobjdump_sass(src) if src.suffix == ".so" else src.read_text()
    funcs = parse_sass(text)
    measured = json.loads(Path(args.latency).read_text()) \
        if args.latency else {}
    fixed = fixed_latencies(funcs)
    for f in funcs:
        if args.function in f.name:
            print(json.dumps(chain(f, Latency(fixed, measured))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
