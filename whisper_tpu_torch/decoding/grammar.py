"""GBNF grammar-constrained decoding.

Counterpart of whisper_tpu/decoding/grammar.py. The vocab scan
(rejected_tokens) and the token accept run in the host C++ runtime
(runtime/native.py) when it is built, on flattened copies of the rules,
stacks and vocab (the rules' and the vocab's kept); the Python machine
here computes the same sets and serves when it is not. reference: grammar
engine src/whisper.cpp:5484-5890 (UTF-8 decode incl. partial sequences,
pushdown-stack advance/accept, candidate rejection, logit penalty) and
the GBNF text parser examples/grammar-parser.cpp.

Host-side by nature (a token-text-dependent stack machine over a pushdown
automaton). A grammar whose reachable state space is finite is compiled
into a token DFA that the device loop gathers from
(decoding/grammar_dfa.py); any other grammar runs this machine live in the
host-stepped loop (decoding/host_loop.py).

Three things make the Python machine cheaper without changing what it
computes: the vocab's code points decoded from a fresh UTF-8 state (what
decode_utf8 returns for any state with no pending bytes) are kept on the
vocab; _match_char's result per (position, code point) is kept for the
instances of one grammar; and with pending bytes, the tokens whose first
byte is not a UTF-8 continuation byte (which decode to the same invalid
sequence) share one verdict.

Element encoding matches the reference enum (src/whisper_grammar.rs:11-116):
END=0 ALT=1 RULE_REF=2 CHAR=3 CHAR_NOT=4 CHAR_RNG_UPPER=5 CHAR_ALT=6.
Rules are lists of (type, value); stack entries are (rule_id, elem_idx)
positions replacing the reference's raw element pointers.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

END = 0
ALT = 1
RULE_REF = 2
CHAR = 3
CHAR_NOT = 4
CHAR_RNG_UPPER = 5
CHAR_ALT = 6

Element = Tuple[int, int]
Rules = List[List[Element]]
Pos = Tuple[int, int]          # (rule_id, element index)
Stack = Tuple[Pos, ...]


@dataclasses.dataclass
class PartialUtf8:
    value: int = 0
    n_remain: int = 0


def decode_utf8(data: bytes, partial: PartialUtf8) -> Tuple[List[int], PartialUtf8]:
    """UTF-8 -> code points, resuming/producing partial sequences
    (reference :5484-5539). Returns codepoints + terminating 0."""
    lookup = [1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 2, 2, 3, 4]
    pos = 0
    cps: List[int] = []
    value = partial.value
    n_remain = partial.n_remain

    while pos < len(data) and n_remain > 0:
        b = data[pos]
        if (b >> 6) != 2:
            return [0], PartialUtf8(0, -1)
        value = (value << 6) + (b & 0x3F)
        pos += 1
        n_remain -= 1

    if partial.n_remain > 0 and n_remain == 0:
        cps.append(value)

    while pos < len(data):
        first = data[pos]
        n_remain = lookup[first >> 4] - 1
        if n_remain < 0:
            return [0], PartialUtf8(0, n_remain)
        mask = (1 << (7 - n_remain)) - 1
        value = first & mask
        pos += 1
        while pos < len(data) and n_remain > 0:
            value = (value << 6) + (data[pos] & 0x3F)
            pos += 1
            n_remain -= 1
        if n_remain == 0:
            cps.append(value)
    cps.append(0)
    return cps, PartialUtf8(value, n_remain)


class Grammar:
    """Pushdown-automaton state (reference whisper_grammar struct)."""

    def __init__(self, rules: Rules, start_rule: int, match_memo=None):
        self.rules = rules
        self._rules_flat = None          # runtime/native.py's flattened rules
        self.partial_utf8 = PartialUtf8()
        self.stacks: List[Stack] = []
        self._match_memo: Dict[Tuple[Pos, int], Tuple[bool, Pos]] = (
            {} if match_memo is None else match_memo)
        # initial stacks from the start rule's alternates (:5789-5812)
        pos = (start_rule, 0)
        while True:
            stack: List[Pos] = []
            if not self._is_end(pos):
                stack.append(pos)
            self._advance_stack(tuple(stack), self.stacks)
            while not self._is_end(pos):
                pos = (pos[0], pos[1] + 1)
            if self._elem(pos)[0] == ALT:
                pos = (pos[0], pos[1] + 1)
            else:
                break

    # -- element helpers ----------------------------------------------------
    def _elem(self, pos: Pos) -> Element:
        return self.rules[pos[0]][pos[1]]

    def _is_end(self, pos: Pos) -> bool:
        return self._elem(pos)[0] in (END, ALT)

    def _match_char(self, pos: Pos, chr_: int) -> Tuple[bool, Pos]:
        """(matched, next element pos) (reference :5551-5573)."""
        key = (pos, chr_)
        res = self._match_memo.get(key)
        if res is None:
            res = self._match_memo[key] = self._match_char_walk(pos, chr_)
        return res

    def _match_char_walk(self, pos: Pos, chr_: int) -> Tuple[bool, Pos]:
        found = False
        is_positive = self._elem(pos)[0] == CHAR
        while True:
            t, v = self._elem(pos)
            nxt = (pos[0], pos[1] + 1)
            if self._elem(nxt)[0] == CHAR_RNG_UPPER:
                found = found or (v <= chr_ <= self._elem(nxt)[1])
                pos = (pos[0], pos[1] + 2)
            else:
                found = found or v == chr_
                pos = nxt
            if self._elem(pos)[0] != CHAR_ALT:
                break
        return found == is_positive, pos

    def _match_partial_char(self, pos: Pos, partial: PartialUtf8) -> bool:
        """(reference :5576-5622)"""
        is_positive = self._elem(pos)[0] == CHAR
        value, n_remain = partial.value, partial.n_remain
        if n_remain < 0 or (n_remain == 1 and value < 2):
            return False
        low = value << (n_remain * 6)
        high = low | ((1 << (n_remain * 6)) - 1)
        if low == 0:
            if n_remain == 2:
                low = 1 << 11
            elif n_remain == 3:
                low = 1 << 16
        while True:
            t, v = self._elem(pos)
            nxt = (pos[0], pos[1] + 1)
            if self._elem(nxt)[0] == CHAR_RNG_UPPER:
                if v <= high and low <= self._elem(nxt)[1]:
                    return is_positive
                pos = (pos[0], pos[1] + 2)
            else:
                if low <= v <= high:
                    return is_positive
                pos = nxt
            if self._elem(pos)[0] != CHAR_ALT:
                break
        return not is_positive

    # -- stack machinery ----------------------------------------------------
    def _advance_stack(self, stack: Stack, out: List[Stack]) -> None:
        """(reference :5627-5679)"""
        if not stack:
            if () not in out:
                out.append(())
            return
        pos = stack[-1]
        t, v = self._elem(pos)
        if t == RULE_REF:
            subpos = (v, 0)
            while True:
                new_stack = list(stack[:-1])
                nxt = (pos[0], pos[1] + 1)
                if not self._is_end(nxt):
                    new_stack.append(nxt)
                if not self._is_end(subpos):
                    new_stack.append(subpos)
                self._advance_stack(tuple(new_stack), out)
                while not self._is_end(subpos):
                    subpos = (subpos[0], subpos[1] + 1)
                if self._elem(subpos)[0] == ALT:
                    subpos = (subpos[0], subpos[1] + 1)
                else:
                    break
        elif t in (CHAR, CHAR_NOT):
            if stack not in out:
                out.append(stack)
        else:
            raise AssertionError("malformed grammar stack")

    def _accept_char(self, stacks: List[Stack], chr_: int) -> List[Stack]:
        """(reference whisper_grammar_accept :5685-5710)"""
        new_stacks: List[Stack] = []
        for stack in stacks:
            if not stack:
                continue
            ok, pos_after = self._match_char(stack[-1], chr_)
            if ok:
                new_stack = list(stack[:-1])
                if not self._is_end(pos_after):
                    new_stack.append(pos_after)
                self._advance_stack(tuple(new_stack), new_stacks)
        return new_stacks

    def _reject_candidates_for_stack(self, stack: Stack, candidates):
        """candidates: list of (token_id, cp_offset, code_points, partial).
        (reference :5718-5767)"""
        rejects = []
        if not stack:
            for cand in candidates:
                tid, off, cps, partial = cand
                if cps[off] != 0 or partial.n_remain != 0:
                    rejects.append(cand)
            return rejects

        stack_pos = stack[-1]
        next_candidates = []
        for cand in candidates:
            tid, off, cps, partial = cand
            if cps[off] == 0:
                if partial.n_remain != 0 and not self._match_partial_char(stack_pos, partial):
                    rejects.append(cand)
            elif self._match_char(stack_pos, cps[off])[0]:
                next_candidates.append((tid, off + 1, cps, partial))
            else:
                rejects.append(cand)

        _, stack_pos_after = self._match_char(stack_pos, 0)
        stack_after = list(stack[:-1])
        if not self._is_end(stack_pos_after):
            stack_after.append(stack_pos_after)
        next_stacks: List[Stack] = []
        self._advance_stack(tuple(stack_after), next_stacks)

        for tid, off, cps, partial in self._reject_candidates(next_stacks, next_candidates):
            rejects.append((tid, off - 1, cps, partial))
        return rejects

    def _reject_candidates(self, stacks: List[Stack], candidates):
        if not candidates or not stacks:
            return []
        rejects = self._reject_candidates_for_stack(stacks[0], candidates)
        for stack in stacks[1:]:
            rejects = self._reject_candidates_for_stack(stack, rejects)
        return rejects

    # -- public API ---------------------------------------------------------
    @staticmethod
    def _vocab_cps(vocab):
        """(token id, text, code points, partial) of every non-empty text
        token, decoded from a fresh UTF-8 state; memoized on the vocab."""
        cands = getattr(vocab, "_grammar_fresh_cps", None)
        if cands is None:
            cands = []
            for tid in range(vocab.token_eot):
                text = vocab.id_to_token[tid]
                if text:
                    cands.append((tid, text, *decode_utf8(text, PartialUtf8())))
            vocab._grammar_fresh_cps = cands
        return cands

    def _native_rules(self):
        if self._rules_flat is None:
            from whisper_tpu_torch.runtime import native
            self._rules_flat = native.flatten_rules(self.rules)
        return self._rules_flat

    @staticmethod
    def _native_vocab(vocab):
        """The text tokens flattened for runtime/native.py; kept on the vocab."""
        flat = getattr(vocab, "_grammar_vocab_flat", None)
        if flat is None:
            from whisper_tpu_torch.runtime import native
            flat = vocab._grammar_vocab_flat = native.flatten_vocab(
                vocab.id_to_token[: vocab.token_eot])
        return flat

    def rejected_tokens(self, vocab) -> List[int]:
        """Token ids the grammar rejects at the current state
        (reference whisper_suppress_invalid_grammar :5824-5866): a scan of
        every text token against every stack, in the host runtime when it
        is built (ascending ids), else in the Python machine."""
        if not self.rules or not self.stacks:
            return []
        from whisper_tpu_torch.runtime import native
        mask = native.grammar_rejects(
            self._native_rules(), self.stacks, self._native_vocab(vocab),
            self.partial_utf8.value, self.partial_utf8.n_remain)
        if mask is not None:
            return np.nonzero(mask)[0].tolist()
        tokens = self._vocab_cps(vocab)
        if self.partial_utf8.n_remain <= 0:
            # no pending bytes: decode_utf8's result depends on the text only
            candidates = [(tid, 0, cps, partial) for tid, _, cps, partial in tokens]
            return [c[0] for c in self._reject_candidates(self.stacks, candidates)]
        # pending bytes: a token whose first byte is not a continuation byte
        # makes decode_utf8 return ([0], partial(0, -1)) at once (:5495), so
        # all such tokens share the verdict of one such candidate (id -1)
        candidates = [(-1, 0, [0], PartialUtf8(0, -1))]
        others = []
        for tid, text, _, _ in tokens:
            if (text[0] >> 6) == 2:
                candidates.append((tid, 0, *decode_utf8(text, self.partial_utf8)))
            else:
                others.append(tid)
        rejects = [c[0] for c in self._reject_candidates(self.stacks, candidates)]
        if -1 not in rejects:
            return rejects
        return [t for t in rejects if t != -1] + others

    def accept_token(self, vocab, token_id: int) -> None:
        """(reference whisper_grammar_accept_token :5869-5890)"""
        if not self.rules or not self.stacks:
            return
        text = vocab.id_to_token[token_id]
        if text.startswith(b"[_"):
            return
        from whisper_tpu_torch.runtime import native
        res = native.grammar_accept(self._native_rules(), self.stacks, text,
                                    self.partial_utf8.value, self.partial_utf8.n_remain)
        if res is not None:
            self.stacks, pv, pr = res
            self.partial_utf8 = PartialUtf8(pv, pr)
            return
        cps, partial = decode_utf8(text, self.partial_utf8)
        for cp in cps[:-1]:
            self.stacks = self._accept_char(self.stacks, cp)
        self.partial_utf8 = partial

    def copy(self) -> "Grammar":
        g = Grammar.__new__(Grammar)
        g.rules = self.rules
        g._rules_flat = self._rules_flat
        g._match_memo = self._match_memo
        g.stacks = list(self.stacks)
        g.partial_utf8 = PartialUtf8(self.partial_utf8.value, self.partial_utf8.n_remain)
        return g


# ---------------------------------------------------------------------------
# GBNF text parser (reference examples/grammar-parser.cpp)
# ---------------------------------------------------------------------------


class GbnfError(ValueError):
    pass


@dataclasses.dataclass
class ParsedGrammar:
    rules: Rules
    start_rule: int
    # _match_char's memo, shared by every instance of these rules
    match_memo: Dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    def instance(self) -> Grammar:
        return Grammar(self.rules, self.start_rule, self.match_memo)


class _Parser:
    def __init__(self, src: str):
        self.src = src
        self.pos = 0
        self.symbol_ids: Dict[str, int] = {}
        self.rules: Dict[int, List[Element]] = {}

    def _get_symbol_id(self, name: str) -> int:
        if name not in self.symbol_ids:
            self.symbol_ids[name] = len(self.symbol_ids)
        return self.symbol_ids[name]

    def _generate_symbol_id(self, base: str) -> int:
        nid = len(self.symbol_ids)
        self.symbol_ids[f"{base}_{nid}"] = nid
        return nid

    def _space(self, newline_ok: bool = True):
        while self.pos < len(self.src):
            c = self.src[self.pos]
            if c == "#":
                while self.pos < len(self.src) and self.src[self.pos] not in "\r\n":
                    self.pos += 1
            elif c in " \t" or (newline_ok and c in "\r\n"):
                self.pos += 1
            else:
                break

    def _name(self) -> str:
        start = self.pos
        while self.pos < len(self.src) and (self.src[self.pos].isalnum()
                                            or self.src[self.pos] in "-_"):
            self.pos += 1
        if self.pos == start:
            raise GbnfError(f"expecting name at position {start}")
        return self.src[start : self.pos]

    def _char(self) -> int:
        c = self.src[self.pos]
        if c == "\\":
            esc = self.src[self.pos + 1]
            self.pos += 2
            if esc == "x":
                v = int(self.src[self.pos : self.pos + 2], 16)
                self.pos += 2
                return v
            if esc == "u":
                v = int(self.src[self.pos : self.pos + 4], 16)
                self.pos += 4
                return v
            if esc == "U":
                v = int(self.src[self.pos : self.pos + 8], 16)
                self.pos += 8
                return v
            return {"t": 9, "r": 13, "n": 10, '"': 34, "[": 91, "]": 93,
                    "\\": 92}.get(esc, ord(esc))
        self.pos += 1
        return ord(c)

    def parse(self) -> Dict[int, List[Element]]:
        self._space()
        while self.pos < len(self.src):
            self._parse_rule()
        # validate rule refs
        for rid, elems in self.rules.items():
            for t, v in elems:
                if t == RULE_REF and v not in self.rules:
                    missing = [n for n, i in self.symbol_ids.items() if i == v]
                    raise GbnfError(f"undefined rule referenced: {missing}")
        return self.rules

    def _parse_rule(self):
        name = self._name()
        self._space(newline_ok=False)
        rule_id = self._get_symbol_id(name)
        if self.src[self.pos : self.pos + 3] != "::=":
            raise GbnfError(f"expecting ::= at position {self.pos}")
        self.pos += 3
        self._space(newline_ok=False)
        self._parse_alternates(name, rule_id)
        if self.pos < len(self.src) and self.src[self.pos] in "\r\n":
            while self.pos < len(self.src) and self.src[self.pos] in "\r\n":
                self.pos += 1
        self._space()

    def _parse_alternates(self, rule_name: str, rule_id: int, nested: bool = False):
        elements: List[Element] = []
        self._parse_sequence(rule_name, elements, nested)
        while self.pos < len(self.src) and self.src[self.pos] == "|":
            elements.append((ALT, 0))
            self.pos += 1
            self._space(newline_ok=True)
            self._parse_sequence(rule_name, elements, nested)
        elements.append((END, 0))
        self.rules[rule_id] = elements

    def _parse_sequence(self, rule_name: str, out: List[Element], nested: bool):
        last_sym_start = len(out)
        while self.pos < len(self.src):
            c = self.src[self.pos]
            if c == '"':
                self.pos += 1
                last_sym_start = len(out)
                while self.src[self.pos] != '"':
                    out.append((CHAR, self._char()))
                self.pos += 1
                self._space(newline_ok=nested)
            elif c == "[":
                self.pos += 1
                start_type = CHAR
                if self.src[self.pos] == "^":
                    self.pos += 1
                    start_type = CHAR_NOT
                last_sym_start = len(out)
                first = True
                while self.src[self.pos] != "]":
                    ch = self._char()
                    t = start_type if first else CHAR_ALT
                    out.append((t, ch))
                    first = False
                    if self.src[self.pos] == "-" and self.src[self.pos + 1] != "]":
                        self.pos += 1
                        out.append((CHAR_RNG_UPPER, self._char()))
                self.pos += 1
                self._space(newline_ok=nested)
            elif c.isalnum() or c in "-_":
                name = self._name()
                ref_id = self._get_symbol_id(name)
                last_sym_start = len(out)
                out.append((RULE_REF, ref_id))
                self._space(newline_ok=nested)
            elif c == "(":
                self.pos += 1
                self._space(newline_ok=True)
                sub_id = self._generate_symbol_id(rule_name)
                self._parse_alternates(rule_name, sub_id, nested=True)
                last_sym_start = len(out)
                out.append((RULE_REF, sub_id))
                if self.src[self.pos] != ")":
                    raise GbnfError(f"expecting ')' at {self.pos}")
                self.pos += 1
                self._space(newline_ok=nested)
            elif c in "*+?":
                if last_sym_start == len(out):
                    raise GbnfError(f"expecting preceding item to */+/? at {self.pos}")
                sub_id = self._generate_symbol_id(rule_name)
                sub: List[Element] = list(out[last_sym_start:])
                if c in "*+":
                    sub.append((RULE_REF, sub_id))
                sub.append((ALT, 0))
                if c == "+":
                    sub.extend(out[last_sym_start:])
                sub.append((END, 0))
                self.rules[sub_id] = sub
                del out[last_sym_start:]
                out.append((RULE_REF, sub_id))
                self.pos += 1
                self._space(newline_ok=nested)
            else:
                break


def parse_gbnf(text: str, start_rule: str = "root") -> ParsedGrammar:
    """GBNF text -> rule arrays (reference grammar_parser::parse)."""
    p = _Parser(text)
    rule_map = p.parse()
    if start_rule not in p.symbol_ids:
        raise GbnfError(f"start rule '{start_rule}' not defined")
    n = len(p.symbol_ids)
    rules: Rules = [[] for _ in range(n)]
    for rid, elems in rule_map.items():
        rules[rid] = elems
    for i, r in enumerate(rules):
        if not r:
            rules[i] = [(END, 0)]
    return ParsedGrammar(rules=rules, start_rule=p.symbol_ids[start_rule])
