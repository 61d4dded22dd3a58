"""The rest of the scalar functions: bitwise, digests and hashes, hex and
HMAC, URL, text, math, the VARBINARY codecs and JSON over VARCHAR.

Counterpart of the scalar breadth of ``trino_tpu/exec/expr.py``
(operator/scalar/BitwiseFunctions, VarbinaryFunctions, HmacFunctions,
UrlFunctions, StringFunctions, MathFunctions, JsonFunctions,
ColorFunctions and WordStemFunction). Numeric work runs on the device;
a function of text runs on the host once per dictionary value, a
function of a number that yields text once per distinct value, and only
the functions of several string columns (concat_ws, format, the string
distances, HMAC) read their rows on the host.

VARBINARY is a dictionary column like VARCHAR whose values carry the
bytes as latin-1 text; the digests and codecs read those bytes, a
VARCHAR's bytes are its UTF-8.
"""

from __future__ import annotations

import hashlib
import hmac
import json
import math
import re
import struct
import unicodedata
import zlib
from typing import Callable, Dict, List
from urllib.parse import parse_qs, quote_plus, unquote_plus, urlsplit

import numpy as np
import torch

from ..columnar import Column
from ..ops.hashing import shr
from ..rex import Const
from ..types import BIGINT, DOUBLE, DecimalType, Type, is_string
from .expr import (_DISPATCH, EvalError, _const_arg, _dict_transform, _f64,
                   _full, _materialize_strings, _merge_valid,
                   _row_string_fn, _strings_column, const_column,
                   eval_expr, per_distinct)

_I64 = torch.int64
_F64 = torch.float64
_INT64_MAX = (1 << 63) - 1
_M64 = (1 << 64) - 1


def _bytes_of(t: Type) -> Callable[[str], bytes]:
    """The bytes of one value: a VARBINARY's carried latin-1 text, a
    VARCHAR's UTF-8."""
    if t.name == "varbinary":
        return lambda s: s.encode("latin-1")
    return lambda s: s.encode()


# ---- bitwise ----------------------------------------------------------------

# the value bits of each integer type, for the logical right shift
_WIDTH = {"tinyint": 8, "smallint": 16, "integer": 32}


def logical_shr(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """x >>> s for 0 <= s < 64 over int64 lanes (torch's >> is
    arithmetic): shift once and clear the sign bit, then the rest is an
    arithmetic shift of a value >= 0."""
    once = (x >> 1) & _INT64_MAX
    return torch.where(s == 0, x, once >> (s - 1).clamp(min=0))


def _bitwise(op: str):
    def h(e, batch):
        a = eval_expr(e.args[0], batch)
        b = eval_expr(e.args[1], batch)
        x, y = a.data.to(_I64), b.data.to(_I64)
        if op == "and":
            d = x & y
        elif op == "or":
            d = x | y
        elif op == "xor":
            d = x ^ y
        else:
            # a shift of the value's width or more gives 0; below it the
            # shift count is taken mod 64, as Java's shifts do
            w = _WIDTH.get(a.type.name, 64)
            s = y & 63
            if op == "lshift":
                d = x << s
            else:
                if w < 64:
                    x = x & ((1 << w) - 1)
                d = logical_shr(x, s)
            d = torch.where(y >= w, torch.zeros_like(d), d)
        return Column(BIGINT, d, _merge_valid(a, b))
    return h


def _bitwise_not(e, batch):
    a = eval_expr(e.args[0], batch)
    return Column(BIGINT, ~a.data.to(_I64), a.valid)


def popcount64(v: torch.Tensor) -> torch.Tensor:
    """Set bits of each int64 lane (all 64, the sign bit too)."""
    v = v - (shr(v, 1) & 0x5555555555555555)
    v = (v & 0x3333333333333333) + (shr(v, 2) & 0x3333333333333333)
    v = (v + shr(v, 4)) & 0x0F0F0F0F0F0F0F0F
    return shr(v * 0x0101010101010101, 56)


def _bit_count(e, batch):
    """bit_count(x, bits): the set bits among the low ``bits`` bits of
    x's two's complement (a negative x counts its sign extension)."""
    a = eval_expr(e.args[0], batch)
    x = a.data.to(_I64)
    valid = a.valid
    if len(e.args) > 1:
        bits = eval_expr(e.args[1], batch)
        n = bits.data.to(_I64)
        mask = torch.where(n >= 64, torch.full_like(n, -1),
                           (torch.ones_like(n) << n.clamp(0, 63)) - 1)
        x = x & mask
        valid = _merge_valid(a, bits)
    return Column(BIGINT, popcount64(x), valid)


# ---- digests, hashes, hex ---------------------------------------------------

def _digest(algo: str):
    def h(e, batch):
        a = eval_expr(e.args[0], batch)
        raw = _bytes_of(a.type)
        return _dict_transform(
            a, lambda v: hashlib.new(algo, raw(v)).hexdigest(), e.type,
            key=(algo, a.type.name))
    return h


def _crc32(e, batch):
    a = eval_expr(e.args[0], batch)
    raw = _bytes_of(a.type)
    return _dict_transform(a, lambda v: zlib.crc32(raw(v)), BIGINT,
                           key=("crc32", a.type.name))


_P1, _P2, _P3 = 0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9
_P4, _P5 = 0x85EBCA77C2B2AE63, 0x27D4EB2F165667C5


def xxh64_many(values: List[bytes]) -> np.ndarray:
    """xxHash64 (seed 0) of many byte strings as int64 patterns: the
    strings of one length at a time, in uint64 numpy lanes."""
    out = np.zeros(len(values), np.uint64)
    by_len: Dict[int, List[int]] = {}
    for i, v in enumerate(values):
        by_len.setdefault(len(v), []).append(i)
    u = np.uint64
    p1, p2, p3, p4, p5 = (u(p) for p in (_P1, _P2, _P3, _P4, _P5))

    def rotl(x, r):
        return (x << u(r)) | (x >> u(64 - r))

    def rnd(acc, lane):
        return rotl(acc + lane * p2, 31) * p1
    with np.errstate(over="ignore"):
        for n, idx in by_len.items():
            buf = np.frombuffer(b"".join(values[i] for i in idx),
                                np.uint8).reshape(len(idx), n)

            def word(at, size):
                w = np.zeros(len(idx), np.uint64)
                for b in range(size):
                    w |= buf[:, at + b].astype(np.uint64) << u(8 * b)
                return w
            i = 0
            if n >= 32:
                v = [np.full(len(idx), x, np.uint64) for x in
                     ((_P1 + _P2) & _M64, _P2, 0, (-_P1) & _M64)]
                while i + 32 <= n:
                    v = [rnd(v[j], word(i + 8 * j, 8)) for j in range(4)]
                    i += 32
                h = rotl(v[0], 1) + rotl(v[1], 7) + rotl(v[2], 12) \
                    + rotl(v[3], 18)
                for vv in v:
                    h = ((h ^ rnd(u(0), vv)) * p1) + p4
            else:
                h = np.full(len(idx), _P5, np.uint64)
            h = h + u(n)
            while i + 8 <= n:
                h = rotl(h ^ rnd(u(0), word(i, 8)), 27) * p1 + p4
                i += 8
            if i + 4 <= n:
                h = rotl(h ^ (word(i, 4) * p1), 23) * p2 + p3
                i += 4
            while i < n:
                h = rotl(h ^ (buf[:, i].astype(np.uint64) * p5), 11) * p1
                i += 1
            h ^= h >> u(33)
            h *= p2
            h ^= h >> u(29)
            h *= p3
            h ^= h >> u(32)
            out[idx] = h
    return out.view(np.int64)


def _xxhash64(e, batch):
    a = eval_expr(e.args[0], batch)
    raw = _bytes_of(a.type)
    return _dict_transform(
        a, None, BIGINT, key=("xxhash64", a.type.name),
        many=lambda vals: xxh64_many([raw(str(v)) for v in vals]).tolist())


def _to_hex(e, batch):
    a = eval_expr(e.args[0], batch)
    if is_string(a.type) or a.type.name == "varbinary":
        raw = _bytes_of(a.type)
        return _dict_transform(a, lambda v: raw(v).hex().upper(), e.type)
    return per_distinct([a.data.to(_I64)], a.valid,
                        lambda v: format(v & _M64, "X"), e.type)


def _from_hex(e, batch):
    a = eval_expr(e.args[0], batch)

    def f(v: str):
        try:
            return bytes.fromhex(v).decode("utf-8", "replace")
        except ValueError as ex:
            raise EvalError(f"from_hex: {ex}") from None
    return _dict_transform(a, f, e.type)


def _hmac(algo: str):
    def h(e, batch):
        a = eval_expr(e.args[0], batch)
        k = eval_expr(e.args[1], batch)
        vb, kb = _bytes_of(a.type), _bytes_of(k.type)
        digest = getattr(hashlib, algo)
        if isinstance(e.args[1], Const):
            key = kb(str(e.args[1].value))
            return _dict_transform(
                a, lambda v: hmac.new(key, vb(v), digest).hexdigest(),
                e.type)
        return _row_string_fn(
            [a, k], lambda v, key: hmac.new(kb(key), vb(v),
                                            digest).hexdigest(), e.type)
    return h


# ---- URL --------------------------------------------------------------------

def _url_part(which: str):
    def h(e, batch):
        a = eval_expr(e.args[0], batch)

        def g(v: str):
            try:
                u = urlsplit(v)
                if which == "port":
                    return u.port
            except ValueError:
                return None
            if which == "protocol":
                return u.scheme or None
            if which == "host":
                return u.hostname
            if which == "path":
                return u.path
            if which == "query":
                return u.query or None
            return u.fragment or None
        return _dict_transform(a, g, e.type)
    return h


def _url_extract_parameter(e, batch):
    a = eval_expr(e.args[0], batch)
    name = _const_arg(e, 1, "url_extract_parameter: name")

    def g(v: str):
        try:
            qs = parse_qs(urlsplit(v).query, keep_blank_values=True)
        except ValueError:
            return None
        vals = qs.get(name)
        return vals[0] if vals else None
    return _dict_transform(a, g, e.type)


def _url_codec(fn):
    def h(e, batch):
        return _dict_transform(eval_expr(e.args[0], batch), fn, e.type)
    return h


# ---- text -------------------------------------------------------------------

def _translate(e, batch):
    a = eval_expr(e.args[0], batch)
    src = str(_const_arg(e, 1, "translate: from"))
    dst = str(_const_arg(e, 2, "translate: to"))
    table: Dict[int, object] = {}
    for i, ch in enumerate(src):
        table.setdefault(ord(ch), dst[i] if i < len(dst) else None)
    return _dict_transform(a, lambda v: v.translate(table), e.type)


def _chr(e, batch):
    a = eval_expr(e.args[0], batch)
    return per_distinct([a.data.to(_I64)], a.valid,
                        lambda v: chr(v) if 0 <= v < 0x110000 else "",
                        e.type)


def _codepoint(e, batch):
    a = eval_expr(e.args[0], batch)
    return _dict_transform(a, lambda v: ord(v[0]) if v else None, BIGINT)


def _concat_ws(e, batch):
    """concat_ws(sep, s1, ...): NULL arguments are skipped; a NULL
    separator gives NULL."""
    mats = [_materialize_strings(eval_expr(a, batch)) for a in e.args]
    out = [None if row[0] is None
           else row[0].join(v for v in row[1:] if v is not None)
           for row in zip(*mats)]
    return _strings_column(out, e.type, batch.device)


def _java_format_value(spec: str, conv: str, v) -> str:
    """One %-directive of Java's String.format through Python's format
    mini-language (flags - 0 , width and precision; conversions s d f e
    g x o b)."""
    grouping = "," in spec
    spec = spec.replace(",", "")
    if spec.startswith("-"):
        spec = "<" + spec[1:]
    if conv == "d":
        return format(int(v), spec + (",d" if grouping else "d"))
    if conv in ("x", "o"):
        return format(int(v), spec + conv)
    if conv in ("f", "e", "g"):
        return format(float(v), spec + ("," if grouping else "") + conv)
    if conv == "b":
        return "true" if v else "false"
    return format(str(v), spec + "s")


def _host_values(c: Column) -> List:
    """A column's rows as python values on the host (None for NULL); a
    decimal as a float, as the format function reads it."""
    if is_string(c.type) or c.dictionary is not None:
        return _materialize_strings(c)
    d = c.data.cpu().numpy()
    valid = (np.ones(len(d), bool) if c.valid is None
             else c.valid.cpu().numpy())
    if isinstance(c.type, DecimalType):
        vals = _f64(c).cpu().numpy()
        return [float(vals[i]) if valid[i] else None for i in range(len(d))]
    return [d[i].item() if valid[i] else None for i in range(len(d))]


def _format(e, batch):
    fmt = str(_const_arg(e, 0, "format: the format string"))
    parts = re.split(r"(%[-,0-9.]*[a-zA-Z]|%%)", fmt)
    mats = [_host_values(eval_expr(a, batch)) for a in e.args[1:]]
    rows = zip(*mats) if mats else [()] * batch.capacity
    out = []
    for row in rows:
        ai, pieces, bad = 0, [], False
        for p in parts:
            if p == "%%":
                pieces.append("%")
            elif p.startswith("%") and len(p) > 1:
                v = row[ai] if ai < len(row) else None
                ai += 1
                if v is None:
                    bad = True
                    break
                pieces.append(_java_format_value(p[1:-1], p[-1], v))
            else:
                pieces.append(p)
        out.append(None if bad else "".join(pieces))
    return _strings_column(out, e.type, batch.device)


def _levenshtein(a: str, b: str) -> int:
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                           prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def _hamming(a: str, b: str) -> int:
    if len(a) != len(b):
        raise EvalError("hamming_distance: the strings must have the same "
                        "length")
    return sum(x != y for x, y in zip(a, b))


def _str_distance(fn):
    def h(e, batch):
        a = eval_expr(e.args[0], batch)
        b = eval_expr(e.args[1], batch)
        ma, mb = _materialize_strings(a), _materialize_strings(b)
        out = np.zeros(len(ma), np.int64)
        valid = np.ones(len(ma), bool)
        for i, (x, y) in enumerate(zip(ma, mb)):
            if x is None or y is None:
                valid[i] = False
            else:
                out[i] = fn(x, y)
        dev = batch.device
        return Column(BIGINT, torch.from_numpy(out).to(dev),
                      None if valid.all()
                      else torch.from_numpy(valid).to(dev))
    return h


def _typeof(e, batch):
    return const_column(Const(str(e.args[0].type), e.type), batch.capacity,
                        batch.device)


def _normalize(e, batch):
    a = eval_expr(e.args[0], batch)
    form = (str(_const_arg(e, 1, "normalize: form")).upper()
            if len(e.args) > 1 else "NFC")
    if form not in ("NFC", "NFD", "NFKC", "NFKD"):
        raise EvalError(f"normalize: invalid form {form}")
    return _dict_transform(a, lambda v: unicodedata.normalize(form, v),
                           e.type)


_BASE_DIGITS = "0123456789abcdefghijklmnopqrstuvwxyz"


def _radix(r: int) -> int:
    if not 2 <= r <= 36:
        raise EvalError("radix must be between 2 and 36")
    return r


def _to_base(e, batch):
    a = eval_expr(e.args[0], batch)
    r = eval_expr(e.args[1], batch)

    def f(v: int, rx: int):
        rx = _radix(rx)
        neg, v = v < 0, abs(v)
        digits = ""
        while True:
            digits = _BASE_DIGITS[v % rx] + digits
            v //= rx
            if v == 0:
                break
        return ("-" if neg else "") + digits
    valid = _merge_valid(a, r)
    return per_distinct([a.data.to(_I64), r.data.to(_I64)], valid, f,
                        e.type)


def _from_base(e, batch):
    a = eval_expr(e.args[0], batch)
    radix = _radix(int(_const_arg(e, 1, "from_base: radix")))

    def f(v: str):
        try:
            return int(v, radix)
        except ValueError:
            raise EvalError(f"from_base: not a number in base {radix}: "
                            f"'{v}'") from None
    return _dict_transform(a, f, BIGINT, key=("from_base", radix))


_PORTER_V = "aeiou"


def _porter_measure(s: str) -> int:
    m, prev_v = 0, False
    for ch in s:
        v = ch in _PORTER_V
        if prev_v and not v:
            m += 1
        prev_v = v
    return m


def _porter_fixup(w: str) -> str:
    if w.endswith(("at", "bl", "iz")):
        return w + "e"
    if (len(w) >= 2 and w[-1] == w[-2]
            and w[-1] not in "lsz" and w[-1] not in _PORTER_V):
        return w[:-1]
    return w


def porter_stem(w: str) -> str:
    """The Porter stemmer's step 1 and its common step-2 suffixes
    (plurals, -ing/-ed, -ation, ...)."""
    if len(w) <= 2:
        return w
    w = w.lower()

    def has_vowel(s):
        return any(c in _PORTER_V for c in s)
    if w.endswith(("sses", "ies")):
        w = w[:-2]
    elif w.endswith("s") and not w.endswith("ss"):
        w = w[:-1]
    if w.endswith("eed"):
        if _porter_measure(w[:-3]) > 0:
            w = w[:-1]
    elif w.endswith("ed") and has_vowel(w[:-2]):
        w = _porter_fixup(w[:-2])
    elif w.endswith("ing") and has_vowel(w[:-3]):
        w = _porter_fixup(w[:-3])
    if w.endswith("y") and has_vowel(w[:-1]):
        w = w[:-1] + "i"
    for suf, rep in (("ational", "ate"), ("tional", "tion"),
                     ("ization", "ize"), ("fulness", "ful"),
                     ("ousness", "ous"), ("iveness", "ive"),
                     ("biliti", "ble"), ("entli", "ent"),
                     ("ousli", "ous"), ("alli", "al"), ("eli", "e")):
        if w.endswith(suf) and _porter_measure(w[:-len(suf)]) > 0:
            return w[:-len(suf)] + rep
    return w


# ---- math -------------------------------------------------------------------

def _log_b(e, batch):
    b = eval_expr(e.args[0], batch)
    x = eval_expr(e.args[1], batch)
    return Column(DOUBLE, torch.log(_f64(x)) / torch.log(_f64(b)),
                  _merge_valid(b, x))


def _atan2(e, batch):
    y = eval_expr(e.args[0], batch)
    x = eval_expr(e.args[1], batch)
    return Column(DOUBLE, torch.atan2(_f64(y), _f64(x)), _merge_valid(y, x))


def _const_double(v: float):
    def h(e, batch):
        return Column(DOUBLE, _full(v, batch.capacity, _F64, batch.device))
    return h


def _random(e, batch):
    """random() in [0, 1); random(n) in [0, n), from a generator of the
    query's device seeded afresh."""
    dev = batch.device
    gen = torch.Generator(device=dev)
    gen.seed()
    u = torch.rand(batch.capacity, generator=gen, dtype=_F64, device=dev)
    if not e.args:
        return Column(DOUBLE, u)
    n = eval_expr(e.args[0], batch)
    hi = n.data.to(_I64).clamp(min=1)
    k = torch.minimum(torch.floor(u * hi.to(_F64)).to(_I64), hi - 1)
    return Column(BIGINT, k, n.valid)


def _width_bucket(e, batch):
    """width_bucket(x, bound1, bound2, n): the bucket of x among n equal
    buckets between the bounds, 0 below and n + 1 above (the bounds may
    run either way). Every division is a tensor division, exact on
    CUDA."""
    x, lo, hi, n = (eval_expr(a, batch) for a in e.args)
    xd, lod, hid = _f64(x), _f64(lo), _f64(hi)
    nn = n.data.to(_I64)
    nd = nn.to(_F64)
    fwd = torch.floor((xd - lod) / ((hid - lod) / nd))
    rev = torch.floor((lod - xd) / ((lod - hid) / nd))
    b = torch.where(hid >= lod, fwd, rev)
    # NaN and infinities saturate before the cast, as the clip does
    b = torch.nan_to_num(b, nan=-1.0, posinf=2.0 ** 62, neginf=-1.0)
    out = torch.minimum(torch.clamp(b.clamp(-1.0, 2.0 ** 62).to(_I64) + 1,
                                    min=0), nn + 1)
    return Column(BIGINT, out, _merge_valid(x, lo, hi, n))


# ---- VARBINARY codecs, bar, color, JSON -------------------------------------

def _retype(e, batch):
    """json_format, color and render: the same text, retyped."""
    a = eval_expr(e.args[0], batch)
    return Column(e.type, a.data, a.valid, a.dictionary)


def _to_utf8(e, batch):
    return _dict_transform(eval_expr(e.args[0], batch),
                           lambda s: s.encode().decode("latin-1"), e.type,
                           key="to_utf8")


def _from_utf8(e, batch):
    return _dict_transform(
        eval_expr(e.args[0], batch),
        lambda s: s.encode("latin-1", errors="replace")
                   .decode("utf-8", errors="replace"), e.type)


def _json_parse(e, batch):
    def canon(v: str):
        try:
            return json.dumps(json.loads(v), separators=(",", ":"))
        except ValueError:
            raise EvalError(f"Cannot convert value to JSON: '{v}'") \
                from None
    return _dict_transform(eval_expr(e.args[0], batch), canon, e.type)


def _to_binary(pack, floats: bool):
    def h(e, batch):
        a = eval_expr(e.args[0], batch)
        lane = a.data.to(_F64 if floats else _I64)
        return per_distinct([lane], a.valid,
                            lambda v: pack(v).decode("latin-1"), e.type)
    return h


def _from_binary(unpack):
    def h(e, batch):
        a = eval_expr(e.args[0], batch)

        def f(s: str):
            try:
                return unpack(s.encode("latin-1"))
            except struct.error as ex:
                raise EvalError(f"{e.fn}: {ex}") from None
        return _dict_transform(a, f, e.type)
    return h


def _unpack_be(nbytes: int):
    def f(b: bytes):
        return int.from_bytes(b[:nbytes].rjust(nbytes, b"\x00"), "big",
                              signed=True)
    return f


def _bar(e, batch):
    """bar(x, width): x in [0, 1] as a bar of block characters (the
    reference's ANSI colour ramp is left out; the geometry matches)."""
    a = eval_expr(e.args[0], batch)
    width = int(_const_arg(e, 1, "bar: width"))

    def f(v: float):
        k = int(round(min(max(v, 0.0), 1.0) * width))
        return "█" * k + " " * (width - k)
    return per_distinct([_f64(a)], a.valid, f, e.type)


_JSON_PATH = re.compile(r"\.([A-Za-z_][A-Za-z0-9_]*)|\[(\d+)\]")


def _json_path(path: str):
    """The steps of a JSONPath of the subset $.a.b, $[0], $.a[2].b."""
    if not path.startswith("$"):
        raise EvalError(f"invalid JSON path: {path}")
    steps, i = [], 1
    while i < len(path):
        m = _JSON_PATH.match(path, i)
        if m is None:
            raise EvalError(f"invalid JSON path: '{path}'")
        steps.append(m.groups())
        i = m.end()
    return steps


def _json_get(doc, steps):
    for name, idx in steps:
        if name:
            if not isinstance(doc, dict) or name not in doc:
                return None
            doc = doc[name]
        else:
            if not isinstance(doc, list) or int(idx) >= len(doc):
                return None
            doc = doc[int(idx)]
    return doc


def _json_fn(kind: str):
    def h(e, batch):
        a = eval_expr(e.args[0], batch)
        steps = _json_path(str(_const_arg(e, 1, "JSON path"))
                           if len(e.args) > 1 else "$")

        def f(v: str):
            try:
                got = _json_get(json.loads(v), steps)
            except ValueError:
                return None
            if kind == "scalar":
                if got is None or isinstance(got, (dict, list)):
                    return None
                if isinstance(got, bool):
                    return "true" if got else "false"
                return str(got)
            if kind == "extract":
                return None if got is None else json.dumps(got)
            if kind == "array_length":
                return len(got) if isinstance(got, list) else None
            if got is None:
                return None
            return len(got) if isinstance(got, (list, dict)) else 0
        return _dict_transform(a, f, e.type)
    return h


DISPATCH: Dict[str, Callable] = {
    "bitwise_and": _bitwise("and"), "bitwise_or": _bitwise("or"),
    "bitwise_xor": _bitwise("xor"),
    "bitwise_left_shift": _bitwise("lshift"),
    "bitwise_right_shift": _bitwise("rshift"),
    "bitwise_not": _bitwise_not, "bit_count": _bit_count,
    "md5": _digest("md5"), "sha1": _digest("sha1"),
    "sha256": _digest("sha256"), "sha512": _digest("sha512"),
    "crc32": _crc32, "xxhash64": _xxhash64,
    "to_hex": _to_hex, "from_hex": _from_hex,
    "hmac_md5": _hmac("md5"), "hmac_sha1": _hmac("sha1"),
    "hmac_sha256": _hmac("sha256"), "hmac_sha512": _hmac("sha512"),
    "url_extract_protocol": _url_part("protocol"),
    "url_extract_host": _url_part("host"),
    "url_extract_port": _url_part("port"),
    "url_extract_path": _url_part("path"),
    "url_extract_query": _url_part("query"),
    "url_extract_fragment": _url_part("fragment"),
    "url_extract_parameter": _url_extract_parameter,
    "url_encode": _url_codec(quote_plus),
    "url_decode": _url_codec(unquote_plus),
    "translate": _translate, "chr": _chr, "codepoint": _codepoint,
    "concat_ws": _concat_ws, "format": _format,
    "levenshtein_distance": _str_distance(_levenshtein),
    "hamming_distance": _str_distance(_hamming),
    "typeof": _typeof, "normalize": _normalize,
    "to_base": _to_base, "from_base": _from_base,
    "word_stem": lambda e, batch: _dict_transform(
        eval_expr(e.args[0], batch), porter_stem, e.type),
    "log": _log_b, "atan2": _atan2,
    "pi": _const_double(math.pi), "e": _const_double(math.e),
    "nan": _const_double(float("nan")),
    "infinity": _const_double(float("inf")),
    "random": _random, "rand": _random,
    "width_bucket": _width_bucket,
    "to_utf8": _to_utf8, "from_utf8": _from_utf8,
    "json_format": _retype, "color": _retype, "render": _retype,
    "json_parse": _json_parse, "bar": _bar,
    "to_big_endian_64": _to_binary(lambda v: struct.pack(">q", v), False),
    "to_big_endian_32": _to_binary(lambda v: struct.pack(">i", v), False),
    "to_ieee754_64": _to_binary(lambda v: struct.pack(">d", v), True),
    "to_ieee754_32": _to_binary(lambda v: struct.pack(">f", v), True),
    "from_big_endian_64": _from_binary(_unpack_be(8)),
    "from_big_endian_32": _from_binary(_unpack_be(4)),
    "from_ieee754_64": _from_binary(
        lambda b: struct.unpack(">d", b[:8])[0]),
    "from_ieee754_32": _from_binary(
        lambda b: struct.unpack(">f", b[:4])[0]),
    "json_extract_scalar": _json_fn("scalar"),
    "json_extract": _json_fn("extract"),
    "json_array_length": _json_fn("array_length"),
    "json_size": _json_fn("size"),
}
_DISPATCH.update(DISPATCH)
