"""Token-level DFA compilation of GBNF grammars for on-device decoding.

Counterpart of whisper_tpu/decoding/grammar_dfa.py, with the same tables:
the port's device loop (decoding/device_loop.py) gathers the reject row of
each decoder's state before the filters and looks up the transition on the
chosen token, so a grammar that compiles never leaves the device loop.

The reference applies grammars on the host every step: it scans all vocab
candidates against the pushdown stacks (whisper_suppress_invalid_grammar,
src/whisper.cpp:5824-5866, invoked from whisper_process_logits :6336) and
accepts the sampled token into the stacks (:7329). Running that machine per
step costs a scan of the whole vocab on the host, so for the common case
where the grammar's reachable state space is finite we precompile the PDA
into a token-level DFA:

    reject[s, v] -> bool   (exactly Grammar.rejected_tokens() at state s)
    trans[s, v]  -> s'     (exactly Grammar.accept_token() at state s)

and decode_window carries one state per decoder: the penalty mask is a
gathered row, the accept is a table lookup, the beam fork is a gather.

State = the exact whisper_grammar state (stacks, partial_utf8), canonicalized
two ways that provably preserve behavior:

1. stacks are deduped + sorted (rejection is an intersection over stacks and
   acceptance a set-map — order/multiplicity never matter);
2. the pending-UTF-8 value is classed by CODEPOINT REGION: the grammar's
   character predicates (char, ranges, alternates, negations) partition the
   codepoint space into finitely many regions within which every predicate
   is constant. A partial whose completion interval [low, high] (exactly as
   whisper_grammar_match_partial_char computes it, :5578-5623) fits inside
   one region behaves identically for every completion, so all such partials
   with the same n_remain collapse to one state (a stored representative
   value replays exact machinery). Without this, every distinct UTF-8 lead
   byte after a soft-penalty off-grammar sample would mint its own state.
   Partials whose interval straddles a boundary (and the value==0 overlong
   special cases) stay keyed by exact value. n_remain <= 0 states zero the
   value: decode_utf8 re-parses fresh in both cases (:5484-5539).

Reject rows come from the same Grammar.rejected_tokens() the host loop calls
and successors from the same decode_utf8 /
_accept_char machinery, so every reference quirk (partial-UTF-8 lookahead,
invalid-byte -1 sentinel, dead-stack pass-through, "[_" special-token skip,
soft-penalty acceptance of rejected tokens) is inherited, not re-derived.

Grammars whose reachable configurations don't close out within the budget
(e.g. center-recursive rules like `root ::= "(" root ")" | "x"`, whose stack
depth is unbounded) make compile_token_dfa return None and the caller falls
back to the host-stepped loop (decoding/host_loop.py), which runs the
pushdown machine live.
"""

from __future__ import annotations

import bisect
import weakref
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from whisper_tpu_torch.decoding.grammar import (CHAR, CHAR_ALT, CHAR_NOT,
                                          CHAR_RNG_UPPER, Grammar,
                                          ParsedGrammar, PartialUtf8,
                                          decode_utf8)


class GrammarDFA:
    """Compiled token-DFA tables.

    reject: (S, V) bool, trans: (S, V) int32 (numpy). `device_tables(dev)`
    returns torch copies on `dev`, uploaded ONCE per device and cached on
    the instance: the trans table alone can reach ~100 MB (512 states x
    51865 vocab int32), so a per-window upload would dominate the decode's
    host-to-device traffic."""

    __slots__ = ("reject", "trans", "start", "n_states", "_dev", "__weakref__")

    def __init__(self, reject: np.ndarray, trans: np.ndarray,
                 start: int, n_states: int):
        self.reject = reject
        self.trans = trans
        self.start = start
        self.n_states = n_states
        self._dev = {}

    def device_tables(self, device):
        """(reject bool, trans int64) tensors on `device`, uploaded once."""
        device = torch.device(device)
        if device not in self._dev:
            self._dev[device] = (torch.from_numpy(self.reject).to(device),
                                 torch.from_numpy(self.trans).to(device, torch.long))
        return self._dev[device]


def _char_boundaries(rules) -> List[int]:
    """Sorted codepoint boundaries at which some grammar predicate changes.
    region(cp) = bisect index; every CHAR/CHAR_NOT test is constant within
    a region."""
    bounds = set()
    for rule in rules:
        i = 0
        while i < len(rule):
            t, v = rule[i]
            if t in (CHAR, CHAR_NOT, CHAR_ALT):
                if i + 1 < len(rule) and rule[i + 1][0] == CHAR_RNG_UPPER:
                    bounds.add(v)
                    bounds.add(rule[i + 1][1] + 1)
                    i += 2
                    continue
                bounds.add(v)
                bounds.add(v + 1)
            i += 1
    return sorted(bounds)


def _partial_interval(value: int, n_remain: int) -> Tuple[int, int]:
    """Completion interval of a pending partial, exactly as
    whisper_grammar_match_partial_char computes it (:5578-5623)."""
    low = value << (n_remain * 6)
    high = low | ((1 << (n_remain * 6)) - 1)
    if value == 0:
        if n_remain == 2:
            low = 1 << 11
        elif n_remain == 3:
            low = 1 << 16
    return low, high


def compile_token_dfa(parsed: ParsedGrammar, vocab,
                      max_states: int = 512,
                      max_work: int = 50_000_000) -> Optional[GrammarDFA]:
    """Compile the grammar x vocab product automaton, or None over budget.

    max_work bounds total fold operations (the Python compile cost);
    max_states bounds the table height. Either trip -> None -> host loop.
    """
    V = vocab.n_vocab
    eot = vocab.token_eot

    scratch = parsed.instance()     # reusable Grammar shell (rules + caches)
    bounds = _char_boundaries(scratch.rules)

    def region(cp: int) -> int:
        return bisect.bisect_right(bounds, cp)

    def canon_ptag(value: int, n_remain: int):
        """Canonical partial tag; value semantics preserved per module doc."""
        if n_remain <= 0:
            return ("z",)
        if value == 0 or (n_remain == 1 and value < 2):
            # overlong low-adjustment + the value<2 early-False in
            # match_partial_char (:5589) — keep these keyed exactly
            return ("v", value, n_remain)
        low, high = _partial_interval(value, n_remain)
        if region(low) == region(high):
            return ("r", region(low), n_remain)
        return ("v", value, n_remain)

    # keys carry a representative partial value so exact machinery replays
    Key = Tuple[Tuple, Tuple]
    rep_val: Dict[Key, int] = {}

    def canon(stacks, partial: PartialUtf8) -> Key:
        ptag = canon_ptag(partial.value, partial.n_remain)
        k = (tuple(sorted(set(stacks))), ptag)
        rep_val.setdefault(k, partial.value if partial.n_remain > 0 else 0)
        return k

    def state_at(k: Key) -> Grammar:
        scratch.stacks = list(k[0])
        n_remain = k[1][2] if k[1][0] != "z" else 0
        scratch.partial_utf8 = PartialUtf8(rep_val[k], n_remain)
        return scratch

    work = 0

    # memoized codepoint step on stack sets, keyed by REGION (all predicates
    # are constant within a region, so the stack evolution is too)
    cp_memo: Dict[Tuple[Tuple, int], Tuple] = {}

    def cp_step(stacks_key: Tuple, cp: int) -> Tuple:
        nonlocal work
        mk = (stacks_key, region(cp))
        res = cp_memo.get(mk)
        if res is None:
            work += len(stacks_key) + 1
            new = scratch._accept_char(list(stacks_key), cp)
            res = tuple(sorted(set(new)))
            cp_memo[mk] = res
        return res

    # per-token fresh decode (state-independent for no-pending states),
    # grouped by signature: tokens with the same region sequence and the
    # same trailing-partial tag share one transition column. sig_id lets
    # whole transition rows be filled by one numpy gather per state.
    sig_index: Dict[Tuple, int] = {}
    sig_rep: List[Tuple] = []           # sig id -> (cps, pval, prem)
    sig_id = np.full(V, -1, np.int32)   # -1: identity (special/empty/"[_")
    cont_first = np.zeros(V, bool)      # text[0] is a UTF-8 continuation byte
    for tid in range(min(eot, V)):
        text = vocab.id_to_token[tid] if tid < len(vocab.id_to_token) else b""
        if not text or text.startswith(b"[_"):
            continue                # accept_token skips these (:5879-5882)
        cont_first[tid] = (text[0] >> 6) == 2
        cps, partial = decode_utf8(text, PartialUtf8())
        body = tuple(cps[:-1])
        sig = (tuple(region(c) for c in body),
               canon_ptag(partial.value, partial.n_remain))
        sid = sig_index.get(sig)
        if sid is None:
            sid = len(sig_rep)
            sig_index[sig] = sid
            sig_rep.append((body, partial.value, partial.n_remain))
        sig_id[tid] = sid
    n_sigs = len(sig_rep)

    keys: Dict[Key, int] = {}
    pending: List[Key] = []

    def intern(k: Key) -> int:
        sid = keys.get(k)
        if sid is None:
            sid = len(keys)
            keys[k] = sid
            pending.append(k)
        return sid

    start = intern(canon(scratch.stacks, scratch.partial_utf8))
    # the decode loop starts every decoder in state 0; intern() numbers the
    # start key first, so this holds structurally — assert it so a future
    # reordering cannot silently desync
    assert start == 0
    reject_rows: List[np.ndarray] = []
    trans_rows: List[np.ndarray] = []

    si = 0
    while si < len(pending):
        k = pending[si]
        si += 1
        if len(keys) > max_states or work > max_work:
            return None

        rej = np.zeros(V, bool)
        trans = np.full(V, keys[k], np.int32)   # identity default (specials,
        #                                         empty text, "[_" prefixes)
        stacks_key, ptag = k
        if not stacks_key:
            # dead state: empty stacks constrain nothing and never change
            # (whisper_suppress_invalid_grammar/_accept_token early-outs)
            reject_rows.append(rej)
            trans_rows.append(trans)
            continue

        g = state_at(k)
        for tid in g.rejected_tokens(vocab):
            rej[tid] = True

        if ptag[0] == "z":
            # no pending bytes: one fold per SIGNATURE, then one gather
            succ_per_sig = np.empty(n_sigs, np.int32)
            for sid in range(n_sigs):
                body, pval, prem = sig_rep[sid]
                cur = stacks_key
                for cp in body:
                    cur = cp_step(cur, cp)
                    if not cur:
                        break
                succ_per_sig[sid] = intern(canon(cur, PartialUtf8(pval, prem)))
                work += len(body) + 1
            sel = sig_id >= 0
            trans[sel] = succ_per_sig[sig_id[sel]]
        else:
            # mid-codepoint state, reachable only via soft-penalty
            # off-grammar samples. Any token whose first byte is NOT a
            # continuation byte hits decode_utf8's invalid-resume early
            # return ([0], partial(0,-1)) before reading further (:5495),
            # so all such tokens share ONE successor; only the few
            # continuation-leading tokens need an exact fold.
            nc_succ = intern(canon(stacks_key, PartialUtf8(0, -1)))
            sel = (sig_id >= 0) & ~cont_first
            trans[sel] = nc_succ
            pu = PartialUtf8(rep_val[k], ptag[2])
            for tid in np.nonzero((sig_id >= 0) & cont_first)[0]:
                text = vocab.id_to_token[int(tid)]
                cps, partial = decode_utf8(text, pu)
                cur = stacks_key
                for cp in cps[:-1]:
                    cur = cp_step(cur, cp)
                    if not cur:
                        break
                trans[tid] = intern(canon(cur, partial))
                work += len(text) + 1
        if len(keys) > max_states or work > max_work:
            return None

        reject_rows.append(rej)
        trans_rows.append(trans)

    return GrammarDFA(
        reject=np.stack(reject_rows),
        trans=np.stack(trans_rows),
        start=start,
        n_states=len(keys),
    )


def cached_dfa(parsed: ParsedGrammar, vocab) -> Optional[GrammarDFA]:
    """compile_token_dfa memoized on the ParsedGrammar instance, keyed by a
    weakref to the vocab: an id()-keyed cache could serve a stale DFA to a
    new vocab allocated at a recycled address."""
    cache = getattr(parsed, "_dfa_cache", None)
    if cache is not None and cache[0]() is vocab:
        return cache[1]
    dfa = compile_token_dfa(parsed, vocab)
    try:
        parsed._dfa_cache = (weakref.ref(vocab), dfa)
    except Exception:
        pass
    return dfa
