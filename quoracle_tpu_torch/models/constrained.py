"""Grammar-constrained decoding: JSON-valid-by-construction sampling.

The PyTorch port's own copy of ``quoracle_tpu/models/constrained.py``
(numpy only, kept identical so both packages build the same tables); the
torch engine caches the table on its device (models/generate.py
``_json_table_device``).

The reference relies on model compliance plus markdown-unwrap recovery
(reference lib/quoracle/utils/json_extractor.ex) and retries whole consensus
rounds when every response fails to parse. On-device serving can do better
(SURVEY.md §7 hard part 4): mask the logits each decode step so only tokens
that keep the output a syntactically valid JSON object are sampleable —
``all_invalid`` retry rounds from malformed JSON become impossible.

TPU-first design: JSON with a bounded nesting depth is a REGULAR language,
so the constraint compiles to a finite automaton. We build

  1. a char-level DFA for one JSON object (strings with escapes + \\uXXXX,
     numbers, true/false/null, nesting up to ``max_depth``), then
  2. a token-level transition table  table[state, token_id] -> state | -1
     by walking every vocab token's text through the char DFA from every
     reachable state (vectorized over states, so the product build is fast).

At decode time the per-row automaton state rides the lax.while_loop carry;
each step is one gather ``table[state]`` → [B, V] allowed mask + where() on
the logits, then ``state = table[state, token]``. Fully shape-static, no
host sync — exactly what the TPU wants. EOS is only sampleable in accept
states (top-level object closed), so constrained rows terminate cleanly.

This guarantees SYNTACTIC validity. With ``action_enum`` set the grammar is
also SCHEMA-AWARE for the decision shape (VERDICT r2 item 7): the top-level
object must open with ``"action": "<name>"`` where the name walks a trie of
the capability-gated action set, and later top-level keys cannot re-spell
``action`` (duplicate keys would let json.loads override the constrained
value). A constrained row therefore cannot propose an unknown action —
the remaining schema conformance (required params, enums) stays with the
validator layer (actions/validator.py), which now only ever sees parseable
JSON naming a real, allowed action.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

REJECT = -1

# --- char-level DFA ---------------------------------------------------------
# State = (mode, stack) with stack a tuple of "O"/"A" frames (bounded depth).
# Modes (suffix _K marks key-string variants inside objects):

WS_VALUE = "ws_value"        # expect a value (or ws)
STRING = "string"            # inside a "value" string
STR_ESC = "str_esc"          # after backslash
STR_U1, STR_U2, STR_U3, STR_U4 = "str_u1", "str_u2", "str_u3", "str_u4"
KEY = "key"                  # inside a key string
KEY_ESC = "key_esc"
KEY_U1, KEY_U2, KEY_U3, KEY_U4 = "key_u1", "key_u2", "key_u3", "key_u4"
AFTER_KEY = "after_key"      # expect ':' (or ws)
OBJ_FIRST = "obj_first"      # after '{': expect key or '}'
OBJ_NEXT = "obj_next"        # after a member: expect ',' or '}'
OBJ_KEY = "obj_key"          # after ',': expect key
ARR_NEXT = "arr_next"        # after an element: expect ',' or ']'
NUM_SIGN = "num_sign"        # after '-'
NUM_ZERO = "num_zero"        # a leading 0: no further int digits (RFC 8259)
NUM_INT = "num_int"          # integer digits
NUM_DOT = "num_dot"          # after '.'
NUM_FRAC = "num_frac"        # fraction digits
NUM_E = "num_e"              # after e/E
NUM_ESIGN = "num_esign"      # after e+/e-
NUM_EXP = "num_exp"          # exponent digits
DONE = "done"                # top-level object closed (accept; ws allowed)

_WS = " \t\n\r"
_DIGITS = "0123456789"
_HEX = "0123456789abcdefABCDEF"
# chars legal inside a JSON string without escaping (any codepoint except
# '"', '\\', and control chars; we operate on utf-8 BYTES >= 0x20)
_KEYWORDS = {"true", "false", "null"}


def _kw_states():
    """Keyword-progress modes: kw:<word>:<i> after matching word[:i]."""
    out = []
    for w in _KEYWORDS:
        for i in range(1, len(w)):
            out.append(f"kw:{w}:{i}")
    return out


ACTION_KEY = "action"


class CharDFA:
    """Explicit-state JSON automaton over bytes. Built by BFS from the start
    state; transitions computed on demand by `step`.

    ``action_enum``: when set, the top-level object is forced to open with
    ``"action": "<member>"`` (member walked through a prefix trie) and
    subsequent top-level keys may not spell ``action`` again (escapes are
    banned in top-level keys so \\u0061-style respellings can't sneak a
    duplicate in). Nested objects stay fully generic."""

    def __init__(self, max_depth: int = 5,
                 action_enum: Optional[Sequence[str]] = None,
                 limit_ws: bool = True):
        """``limit_ws``: cap inter-token whitespace to ONE char. Strings
        are untouched (a space there is content). This restricts the
        grammar to compact(ish) JSON — for SAMPLING that is strictly
        better: an unbounded-ws grammar lets a model burn its whole budget
        on whitespace runs without ever being forced toward content."""
        self.max_depth = max_depth
        self.limit_ws = limit_ws
        self.action_enum = (tuple(sorted(set(action_enum)))
                            if action_enum else None)
        if self.action_enum:
            self._enum_prefixes = {w[:i] for w in self.action_enum
                                   for i in range(len(w) + 1)}
            self._act_prefixes = {ACTION_KEY[:i]
                                  for i in range(len(ACTION_KEY) + 1)}
        # top level must be an OBJECT (the action-proposal shape), not any
        # bare JSON value
        self.start = (WS_VALUE + ":obj_only", ())
        # enumerate reachable states
        self.states: dict[tuple, int] = {}
        self.trans: Optional[np.ndarray] = None
        self._build()

    # -- single-char transition over abstract states -----------------------

    def _value_start(self, ch: str, stack: tuple):
        """Transitions out of WS_VALUE (expecting a value)."""
        if ch in _WS:
            return (WS_VALUE, stack)
        if ch == '"':
            return (STRING, stack)
        if ch == "{":
            if len(stack) >= self.max_depth:
                return None
            return (OBJ_FIRST, stack + ("O",))
        if ch == "[":
            if len(stack) >= self.max_depth:
                return None
            # an array may be empty: ']' closes it immediately
            return (WS_VALUE + ":arr0", stack + ("A",))
        if ch == "-":
            return (NUM_SIGN, stack)
        if ch == "0":
            return (NUM_ZERO, stack)   # leading zero ends the int part
        if ch in _DIGITS:
            return (NUM_INT, stack)
        for w in _KEYWORDS:
            if ch == w[0]:
                return (f"kw:{w}:1", stack)
        return None

    def _close_value(self, stack: tuple):
        """A value just finished; what mode follows depends on the frame."""
        if not stack:
            return (DONE, ())
        return (OBJ_NEXT if stack[-1] == "O" else ARR_NEXT, stack)

    # modes where a 0x20 space is string CONTENT, not whitespace
    _STRINGY_PREFIXES = ("key1:", "kw:")

    def _stringy(self, mode: str) -> bool:
        return mode in (STRING, KEY, STR_ESC, KEY_ESC, STR_U1, STR_U2,
                        STR_U3, STR_U4, KEY_U1, KEY_U2, KEY_U3, KEY_U4) \
            or mode.startswith(self._STRINGY_PREFIXES)

    # ws-tag sentinel: \x00 cannot appear in any mode name (enum prefixes
    # are action-name chars, key1 progress is capped to "action"-prefixes)
    _WS_TAG = "\x00w"

    def step(self, state: tuple, ch: str) -> Optional[tuple]:
        mode, stack = state
        if self.limit_ws:
            if mode.endswith(self._WS_TAG):   # one ws char consumed already
                if ch in _WS:
                    return None
                return self.step((mode[:-len(self._WS_TAG)], stack), ch)
            if ch in _WS and not self._stringy(mode):
                nxt = self._step_raw(state, ch)
                if nxt is None:
                    return None
                nm, ns = nxt
                # the number-closing path re-enters step() and may have
                # tagged the state already
                if nm.endswith(self._WS_TAG) or self._stringy(nm):
                    return nxt
                return (nm + self._WS_TAG, ns)
        return self._step_raw(state, ch)

    def _step_raw(self, state: tuple, ch: str) -> Optional[tuple]:
        mode, stack = state

        # ---- action-enum modes (schema-aware top-level object) ----------
        if self.action_enum is not None:
            if mode == WS_VALUE + ":obj_only":
                if ch in _WS:
                    return (mode, stack)
                if ch == "{":
                    return ("act_ws", ("O",))
                return None
            if mode == "act_ws":           # expect the forced "action" key
                if ch in _WS:
                    return (mode, stack)
                if ch == '"':
                    return ("actkey:0", stack)
                return None
            if mode.startswith("actkey:"):
                i = int(mode[7:])
                if i == len(ACTION_KEY):
                    return ("act_colon", stack) if ch == '"' else None
                return (f"actkey:{i + 1}", stack) \
                    if ch == ACTION_KEY[i] else None
            if mode == "act_colon":
                if ch in _WS:
                    return (mode, stack)
                if ch == ":":
                    return ("act_valws", stack)
                return None
            if mode == "act_valws":
                if ch in _WS:
                    return (mode, stack)
                if ch == '"':
                    return ("enum:", stack)
                return None
            if mode.startswith("enum:"):   # walk the action-name trie
                prefix = mode[5:]
                if ch == '"' and prefix in self.action_enum:
                    return (OBJ_NEXT, stack)
                if prefix + ch in self._enum_prefixes:
                    return (f"enum:{prefix + ch}", stack)
                return None
            if mode.startswith("key1:"):   # later top-level keys: ≠ action
                prog = mode[5:]
                if ch == '"':
                    return None if prog == ACTION_KEY else (AFTER_KEY, stack)
                if ch == "\\":
                    return None            # no escapes in top-level keys
                if ord(ch) >= 0x20:
                    nxt = prog + ch
                    marker = nxt if nxt in self._act_prefixes else "x"
                    return (f"key1:{marker}", stack)
                return None

        # value start (including the empty-array / object-only specials)
        if mode == WS_VALUE or mode.startswith(WS_VALUE):
            if mode == WS_VALUE + ":arr0" and ch == "]":
                return self._close_value(stack[:-1])
            if mode == WS_VALUE + ":obj_only" and ch not in _WS + "{":
                return None
            nxt = self._value_start(ch, stack)
            if nxt is None:
                return None
            # preserve the arr0/obj_only marker across leading whitespace
            if nxt[0] == WS_VALUE and mode != WS_VALUE:
                return (mode, stack)
            return nxt

        # strings (value + key variants share logic)
        if mode in (STRING, KEY):
            is_key = mode == KEY
            if ch == '"':
                return (AFTER_KEY, stack) if is_key \
                    else self._close_value(stack)
            if ch == "\\":
                return (KEY_ESC if is_key else STR_ESC, stack)
            if ord(ch) >= 0x20:
                return (mode, stack)
            return None
        if mode in (STR_ESC, KEY_ESC):
            is_key = mode == KEY_ESC
            if ch in '"\\/bfnrt':
                return (KEY if is_key else STRING, stack)
            if ch == "u":
                return (KEY_U1 if is_key else STR_U1, stack)
            return None
        for seq, nxt_mode, final in (
                ((STR_U1, STR_U2, STR_U3, STR_U4), None, STRING),
                ((KEY_U1, KEY_U2, KEY_U3, KEY_U4), None, KEY)):
            if mode in seq:
                if ch not in _HEX:
                    return None
                i = seq.index(mode)
                return (final if i == 3 else seq[i + 1], stack)

        # keywords
        if mode.startswith("kw:"):
            _, w, i = mode.split(":")
            i = int(i)
            if ch != w[i]:
                return None
            if i + 1 == len(w):
                return self._close_value(stack)
            return (f"kw:{w}:{i + 1}", stack)

        # numbers — a number ends on a delimiter, which must ALSO be
        # processed (ws/,/}/]) from the closed-value state
        if mode in (NUM_SIGN, NUM_DOT, NUM_ESIGN, NUM_E):
            if mode == NUM_E and ch in "+-":
                return (NUM_ESIGN, stack)
            if mode == NUM_SIGN and ch == "0":
                return (NUM_ZERO, stack)   # -0 also ends the int part
            if ch in _DIGITS:
                return {NUM_SIGN: NUM_INT, NUM_DOT: NUM_FRAC,
                        NUM_ESIGN: NUM_EXP, NUM_E: NUM_EXP}[mode], stack
            return None
        if mode in (NUM_INT, NUM_ZERO, NUM_FRAC, NUM_EXP):
            if ch in _DIGITS:
                if mode == NUM_ZERO:
                    return None            # RFC 8259: no leading zeros
                return (mode, stack)
            if mode in (NUM_INT, NUM_ZERO) and ch == ".":
                return (NUM_DOT, stack)
            if mode in (NUM_INT, NUM_ZERO, NUM_FRAC) and ch in "eE":
                return (NUM_E, stack)
            closed = self._close_value(stack)
            return self.step(closed, ch)   # delimiter handled by next mode

        # object plumbing
        if mode == OBJ_FIRST:
            if ch in _WS:
                return (mode, stack)
            if ch == "}":
                return self._close_value(stack[:-1])
            if ch == '"':
                return (KEY, stack)
            return None
        if mode == OBJ_KEY:
            if ch in _WS:
                return (mode, stack)
            if ch == '"':
                if self.action_enum is not None and stack == ("O",):
                    return ("key1:", stack)   # top-level: guard dup "action"
                return (KEY, stack)
            return None
        if mode == AFTER_KEY:
            if ch in _WS:
                return (mode, stack)
            if ch == ":":
                return (WS_VALUE, stack)
            return None
        if mode == OBJ_NEXT:
            if ch in _WS:
                return (mode, stack)
            if ch == ",":
                return (OBJ_KEY, stack)
            if ch == "}":
                return self._close_value(stack[:-1])
            return None
        if mode == ARR_NEXT:
            if ch in _WS:
                return (mode, stack)
            if ch == ",":
                return (WS_VALUE, stack)
            if ch == "]":
                return self._close_value(stack[:-1])
            return None

        if mode == DONE:
            return (DONE, ()) if ch in _WS else None
        return None

    # -- enumeration -------------------------------------------------------

    _CHARS = [chr(c) for c in range(0x20, 0x7F)] + list("\t\n\r") \
        + [chr(0xFFFD)]   # replacement char stands in for any non-ascii byte

    def _build(self) -> None:
        from collections import deque
        idx = {self.start: 0}
        q = deque([self.start])
        while q:
            s = q.popleft()
            for ch in self._CHARS:
                t = self.step(s, ch)
                if t is not None and t not in idx:
                    idx[t] = len(idx)
                    q.append(t)
        n = len(idx)
        trans = np.full((n, len(self._CHARS)), REJECT, np.int32)
        for s, i in idx.items():
            for ci, ch in enumerate(self._CHARS):
                t = self.step(s, ch)
                if t is not None:
                    trans[i, ci] = idx[t]
        accept = np.zeros(n, bool)
        for s, i in idx.items():
            accept[i] = s[0] in (DONE, DONE + "\x00w")
        self.states = idx
        self.trans, self.accept = self._minimize(trans, accept)
        start_class = self._class_of[idx[self.start]]
        self.states = {s: self._class_of[i] for s, i in idx.items()}
        # keep self.start mapping coherent
        self.start_id = start_class

    def _minimize(self, trans: np.ndarray, accept: np.ndarray):
        """Moore partition refinement — the raw product construction is
        state-heavy (keyword progress × stack configs), and the table's
        device footprint is n_states × vocab, so minimizing here cuts HBM
        several-fold for 128k vocabs."""
        n = trans.shape[0]
        # initial classes: accept vs not (REJECT is its own implicit class)
        cls = accept.astype(np.int64)
        while True:
            # signature = (class, classes of all transitions)
            tcls = np.where(trans >= 0, cls[np.clip(trans, 0, None)], -1)
            sig = np.concatenate([cls[:, None], tcls], axis=1)
            _, new_cls = np.unique(sig, axis=0, return_inverse=True)
            if np.array_equal(new_cls, cls):
                break
            cls = new_cls
        m = int(cls.max()) + 1
        new_trans = np.full((m, trans.shape[1]), REJECT, np.int32)
        new_accept = np.zeros(m, bool)
        for i in range(n):
            c = cls[i]
            new_accept[c] = accept[i]
            new_trans[c] = np.where(trans[i] >= 0,
                                    cls[np.clip(trans[i], 0, None)], REJECT)
        self._class_of = cls
        return new_trans, new_accept

    def char_index(self, ch: str) -> int:
        try:
            return self._CHARS.index(ch)
        except ValueError:
            # Control chars beyond \t\n\r are forbidden EVERYWHERE in JSON
            # (strings require \u escapes for them) — they must not fall
            # into the string-safe replacement bucket.
            if ord(ch) < 0x20:
                return -1
            return len(self._CHARS) - 1   # non-ascii → replacement bucket


# --- token-level table ------------------------------------------------------

class JsonTokenTable:
    """table[state, token] -> next state (or REJECT). Built once per
    tokenizer; vectorized over states so 32k-128k vocabs build in seconds."""

    def __init__(self, token_texts: list[str], eos_id: int,
                 max_depth: int = 4, extra_stop_ids: tuple = (),
                 action_enum: Optional[Sequence[str]] = None):
        dfa = CharDFA(max_depth=max_depth, action_enum=action_enum)
        n_states = dfa.trans.shape[0]     # minimized class count
        vocab = len(token_texts)
        table = np.full((n_states, vocab), REJECT, np.int32)

        all_states = np.arange(n_states, dtype=np.int32)
        reject_row = np.full(n_states, REJECT, np.int32)
        for tid, text in enumerate(token_texts):
            if not text:
                continue                   # specials: never sampleable
            cur = all_states
            dead = False
            for ch in text:
                ci = dfa.char_index(ch)
                if ci < 0:            # forbidden char: token never legal
                    dead = True
                    break
                nxt = np.where(cur >= 0, dfa.trans[np.clip(cur, 0, None), ci],
                               REJECT)
                cur = nxt
                if not np.any(cur >= 0):
                    dead = True
                    break
            table[:, tid] = reject_row if dead else cur
        # EOS: sampleable exactly in accept states; self-loop so done rows
        # stay valid.
        for sid in np.nonzero(dfa.accept)[0]:
            for stop in (eos_id, *extra_stop_ids):
                if 0 <= stop < vocab:
                    table[sid, stop] = sid
        assert n_states < 32767, "state space exceeds int16"
        # Pad the state axis to a bucket so differently-sized enum grammars
        # share one decode compilation (the table is a traced jit arg; its
        # SHAPE keys the compile cache). Pad rows are all-REJECT.
        padded = n_states
        for b in (128, 256, 384, 512, 640, 768, 1024, 1536, 2048, 4096,
                  8192):
            if n_states <= b:
                padded = b
                break
        if padded > n_states:
            table = np.concatenate(
                [table, np.full((padded - n_states, vocab), REJECT,
                                np.int32)], axis=0)
        self.table = table.astype(np.int16)   # halves the device footprint
        self.start_state = int(dfa.start_id)
        self.n_states = n_states
        self.accept = dfa.accept

    @classmethod
    def for_tokenizer(cls, tokenizer, vocab_size: int, eos_id: int,
                      extra_stop_ids: tuple = (),
                      action_enum: Optional[Sequence[str]] = None,
                      ) -> "JsonTokenTable":
        texts = []
        for tid in range(vocab_size):
            try:
                texts.append(tokenizer.decode([tid]))
            except Exception:
                texts.append("")
        # EOS/BOS often decode to ""/text; force specials empty so only the
        # accept-state rule can allow EOS.
        for sid in {eos_id, getattr(tokenizer, "bos_id", -1),
                    getattr(tokenizer, "pad_id", -1), *extra_stop_ids}:
            if 0 <= sid < vocab_size:
                texts[sid] = ""
        return cls(texts, eos_id, extra_stop_ids=extra_stop_ids,
                   action_enum=action_enum)
