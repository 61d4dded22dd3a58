"""Function registry: name + argument types -> result type.

Reference parity: core/trino-main/.../metadata/FunctionRegistry.java:368
(~267 builtins) + SignatureBinder overload resolution, collapsed to a
type-directed table because the TPU engine dispatches execution on
(name, physical lane dtype) in the evaluator rather than on MethodHandles.
Implementations live in exec/scalars.py; this module is pure typing.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

from .types import (BIGINT, BOOLEAN, DATE, DOUBLE, INTEGER, REAL, UNKNOWN,
                    VARCHAR, DecimalType, TimestampType, Type, VarcharType,
                    common_super_type, is_exact_numeric, is_integral,
                    is_numeric, is_string, GEOMETRY)

# --- aggregates -----------------------------------------------------------

AGGREGATE_NAMES = {
    "sum", "min", "max", "avg", "count", "count_if", "any_value",
    "arbitrary", "bool_and", "bool_or", "every", "stddev", "stddev_samp",
    "stddev_pop", "variance", "var_samp", "var_pop", "geometric_mean",
    "approx_distinct", "min_by", "max_by", "array_agg", "checksum",
    "corr", "covar_samp", "covar_pop", "regr_slope", "regr_intercept",
    "skewness", "kurtosis", "approx_percentile", "map_agg", "histogram",
    "approx_most_frequent", "approx_set", "merge",
    "bitwise_and_agg", "bitwise_or_agg", "map_union", "multimap_agg",
    "numeric_histogram", "tdigest_agg", "qdigest_agg",
}

WINDOW_ONLY_NAMES = {
    "row_number", "rank", "dense_rank", "percent_rank", "cume_dist",
    "ntile", "first_value", "last_value", "nth_value", "lag", "lead",
}


def aggregate_result_type(name: str, arg_types: Sequence[Type]) -> Type:
    """Result type of an aggregate (reference: operator/aggregation/*
    output types, SURVEY.md Appendix A.7)."""
    t = arg_types[0] if arg_types else None
    if name == "count" or name == "count_if" or name == "approx_distinct":
        return BIGINT
    if name == "sum":
        if is_integral(t):
            return BIGINT
        if isinstance(t, DecimalType):
            return DecimalType(38, t.scale)
        return t
    if name in ("min", "max", "any_value", "arbitrary",
                "approx_percentile"):
        return t
    if name in ("min_by", "max_by"):
        return t
    if name == "avg":
        if isinstance(t, DecimalType):
            return t
        if t is REAL:
            return REAL
        return DOUBLE
    if name in ("bool_and", "bool_or", "every"):
        return BOOLEAN
    if name in ("stddev", "stddev_samp", "stddev_pop", "variance",
                "var_samp", "var_pop", "geometric_mean", "corr",
                "covar_samp", "covar_pop", "regr_slope", "regr_intercept",
                "skewness", "kurtosis"):
        return DOUBLE
    if name == "checksum":
        return BIGINT
    if name in ("bitwise_and_agg", "bitwise_or_agg"):
        if not is_integral(t):
            raise FunctionResolutionError(
                f"{name}({t}) not supported: argument must be integral")
        return BIGINT
    if name == "map_union":
        from .types import MapType
        if not isinstance(t, MapType):
            raise FunctionResolutionError(
                f"map_union({t}) not supported: argument must be a map")
        return t
    if name == "multimap_agg":
        from .types import ArrayType, MapType
        return MapType(arg_types[0], ArrayType(arg_types[1]))
    if name == "numeric_histogram":
        from .types import MapType
        return MapType(DOUBLE, DOUBLE)
    if name == "approx_set":
        # declared bits match the runtime sketch (ops/hll.py
        # APPROX_SET_BUCKET_BITS); an explicit max-error argument
        # re-types the aggregate at plan time (planner/logical.py)
        from .types import HyperLogLogType
        from .ops.hll import APPROX_SET_BUCKET_BITS
        return HyperLogLogType(APPROX_SET_BUCKET_BITS)
    if name == "merge":
        # merge() combines sketch values — result type follows the
        # input (HLL, tdigest or qdigest, like the reference)
        from .types import HyperLogLogType, QDigestType, TDigestType
        if not isinstance(t, (HyperLogLogType, TDigestType,
                              QDigestType)):
            raise FunctionResolutionError(
                f"merge({t}) not supported: argument must be a "
                "HyperLogLog / tdigest / qdigest sketch")
        return t
    if name == "tdigest_agg":
        from .types import T_DIGEST
        if not is_numeric(t):
            raise FunctionResolutionError(
                f"tdigest_agg({t}) not supported")
        return T_DIGEST
    if name == "qdigest_agg":
        from .types import QDigestType
        if not is_numeric(t):
            raise FunctionResolutionError(
                f"qdigest_agg({t}) not supported")
        return QDigestType(t)
    if name == "array_agg":
        from .types import ArrayType
        return ArrayType(t)
    if name == "map_agg":
        from .types import MapType
        return MapType(arg_types[0], arg_types[1])
    if name == "histogram":
        from .types import MapType
        return MapType(t, BIGINT)
    if name == "approx_most_frequent":
        from .types import MapType
        return MapType(arg_types[1] if len(arg_types) > 1 else t,
                       BIGINT)
    raise KeyError(f"unknown aggregate: {name}")


# --- scalars --------------------------------------------------------------

class FunctionResolutionError(Exception):
    pass


def _numeric_unary(name, args):
    t = args[0]
    if not is_numeric(t):
        raise FunctionResolutionError(f"{name}({t}) not supported")
    return t


def _double_fn(name, args):
    for t in args:
        if not is_numeric(t):
            raise FunctionResolutionError(f"{name}({t}) not supported")
    return DOUBLE


def _common(name, args):
    out = args[0]
    for t in args[1:]:
        nxt = common_super_type(out, t)
        if nxt is None:
            raise FunctionResolutionError(
                f"{name}: incompatible types {out}, {t}")
        out = nxt
    return out


def _varchar_fn(name, args):
    return VARCHAR


def _bigint_fn(name, args):
    return BIGINT


def _varbinary_fn(name, args):
    from .types import VARBINARY
    return VARBINARY


def _double_fn_maps(name, args):
    from .types import MapType
    for t in args:
        if not isinstance(t, MapType):
            raise FunctionResolutionError(
                f"{name} requires map(varchar, double) arguments")
    return DOUBLE


def _zip_type(name, args):
    from .types import ArrayType, RowType
    for t in args:
        if not isinstance(t, ArrayType):
            raise FunctionResolutionError(f"{name} requires arrays")
    return ArrayType(RowType(
        [(f"field{i}", t.element) for i, t in enumerate(args)]))


def _map_from_entries_type(name, args):
    from .types import ArrayType, MapType, RowType
    if (not args or not isinstance(args[0], ArrayType)
            or not isinstance(args[0].element, RowType)
            or len(args[0].element.fields) != 2):
        raise FunctionResolutionError(
            f"{name} requires array(row(K, V))")
    f = args[0].element.fields
    return MapType(f[0][1], f[1][1])


def _multimap_from_entries_type(name, args):
    from .types import ArrayType, MapType
    m = _map_from_entries_type(name, args)
    return MapType(m.key, ArrayType(m.value))


def _split_to_multimap_type():
    from .types import ArrayType, MapType
    return MapType(VARCHAR, ArrayType(VARCHAR))


def _value_at_quantile_type(name, args):
    from .types import QDigestType, TDigestType
    if not args or not isinstance(args[0], (TDigestType, QDigestType)):
        raise FunctionResolutionError(
            f"{name} requires a tdigest/qdigest argument")
    if isinstance(args[0], QDigestType):
        return args[0].value_type
    return DOUBLE


def _double_fn_sketch(name, args):
    _value_at_quantile_type(name, args)
    return DOUBLE


_SCALARS: Dict[str, Callable[[str, Sequence[Type]], Type]] = {
    # math (operator/scalar/MathFunctions.java)
    "abs": _numeric_unary,
    "negate": _numeric_unary,
    "round": lambda n, a: a[0] if not is_string(a[0]) else _err(n, a),
    "floor": _numeric_unary,
    "ceil": _numeric_unary,
    "ceiling": _numeric_unary,
    "truncate": _numeric_unary,
    "sqrt": _double_fn, "cbrt": _double_fn, "exp": _double_fn,
    "ln": _double_fn, "log2": _double_fn, "log10": _double_fn,
    "power": _double_fn, "pow": _double_fn,
    "sin": _double_fn, "cos": _double_fn, "tan": _double_fn,
    "asin": _double_fn, "acos": _double_fn, "atan": _double_fn,
    "atan2": _double_fn, "sinh": _double_fn, "cosh": _double_fn,
    "tanh": _double_fn, "degrees": _double_fn, "radians": _double_fn,
    "sign": _numeric_unary,
    "mod": _common,
    "pi": lambda n, a: DOUBLE,
    "e": lambda n, a: DOUBLE,
    "random": lambda n, a: DOUBLE,
    "rand": lambda n, a: DOUBLE,
    "nan": lambda n, a: DOUBLE,
    "infinity": lambda n, a: DOUBLE,
    "is_nan": lambda n, a: BOOLEAN,
    "is_finite": lambda n, a: BOOLEAN,
    "is_infinite": lambda n, a: BOOLEAN,
    "greatest": _common, "least": _common,
    "width_bucket": _bigint_fn,
    # geospatial core (plugin/trino-geospatial GeoFunctions; TPU-first
    # point lanes — ops/geo.py)
    "st_point": lambda n, a: GEOMETRY,
    "st_geometryfromtext": lambda n, a: GEOMETRY,
    "st_astext": lambda n, a: VARCHAR,
    "st_x": lambda n, a: DOUBLE, "st_y": lambda n, a: DOUBLE,
    "st_distance": lambda n, a: DOUBLE,
    "st_contains": lambda n, a: BOOLEAN,
    "great_circle_distance": _double_fn,
    # conditional (SpecialForm in the reference)
    "coalesce": _common,
    "nullif": lambda n, a: a[0],
    "if": lambda n, a: _common(n, a[1:]),
    "try": lambda n, a: a[0],
    # strings (operator/scalar/StringFunctions.java)
    "length": _bigint_fn,
    "lower": _varchar_fn, "upper": _varchar_fn,
    "trim": _varchar_fn, "ltrim": _varchar_fn, "rtrim": _varchar_fn,
    "reverse": _varchar_fn,
    "substring": _varchar_fn, "substr": _varchar_fn,
    "replace": _varchar_fn,
    "concat": _varchar_fn,
    "concat_ws": _varchar_fn,
    "strpos": _bigint_fn,
    "position": _bigint_fn,
    "split_part": _varchar_fn,
    "lpad": _varchar_fn, "rpad": _varchar_fn,
    "chr": _varchar_fn,
    "codepoint": _bigint_fn,
    "starts_with": lambda n, a: BOOLEAN,
    "hamming_distance": _bigint_fn,
    "levenshtein_distance": _bigint_fn,
    "regexp_like": lambda n, a: BOOLEAN,
    "regexp_replace": _varchar_fn,
    "regexp_extract": _varchar_fn,
    "regexp_extract_all": lambda n, a: _mk_array(VARCHAR),
    "regexp_split": lambda n, a: _mk_array(VARCHAR),
    "split": lambda n, a: _mk_array(VARCHAR),
    "split_to_map": lambda n, a: _split_to_map_type(),
    "normalize": _varchar_fn,
    "to_base": _varchar_fn,
    "from_base": _bigint_fn,
    "format": _varchar_fn,
    # datetime (operator/scalar/DateTimeFunctions.java)
    "year": _bigint_fn, "quarter": _bigint_fn, "month": _bigint_fn,
    "week": _bigint_fn, "day": _bigint_fn, "day_of_month": _bigint_fn,
    "day_of_week": _bigint_fn, "dow": _bigint_fn,
    "day_of_year": _bigint_fn, "doy": _bigint_fn,
    "year_of_week": _bigint_fn, "yow": _bigint_fn,
    "hour": _bigint_fn, "minute": _bigint_fn, "second": _bigint_fn,
    "millisecond": _bigint_fn,
    "date_trunc": lambda n, a: a[1],
    "date_add": lambda n, a: a[2],
    "date_diff": _bigint_fn,
    "date": lambda n, a: DATE,
    "current_date": lambda n, a: DATE,
    "now": lambda n, a: TimestampType(3),
    "current_timestamp": lambda n, a: TimestampType(3),
    "localtimestamp": lambda n, a: TimestampType(3),
    "current_time": lambda n, a: _time_type(),
    "localtime": lambda n, a: _time_type(),
    "from_unixtime": lambda n, a: TimestampType(3),
    "to_unixtime": lambda n, a: DOUBLE,
    "date_format": _varchar_fn,
    "date_parse": lambda n, a: TimestampType(3),
    "at_timezone": lambda n, a: _tstz(a),
    "with_timezone": lambda n, a: _tstz(a),
    "to_iso8601": _varchar_fn,
    # misc
    "typeof": _varchar_fn,
    "to_hex": _varchar_fn,
    "from_hex": lambda n, a: VARCHAR,
    "xxhash64": _bigint_fn,
    # bitwise (operator/scalar/BitwiseFunctions.java)
    "bitwise_and": _bigint_fn, "bitwise_or": _bigint_fn,
    "bitwise_xor": _bigint_fn, "bitwise_not": _bigint_fn,
    "bitwise_left_shift": _bigint_fn,
    "bitwise_right_shift": _bigint_fn,
    "bit_count": _bigint_fn,
    # digests (VarbinaryFunctions; ours return hex varchar)
    "md5": _varchar_fn, "sha1": _varchar_fn, "sha256": _varchar_fn,
    "sha512": _varchar_fn, "crc32": _bigint_fn,
    # URL (operator/scalar/UrlFunctions.java)
    "url_extract_protocol": _varchar_fn,
    "url_extract_host": _varchar_fn,
    "url_extract_port": _bigint_fn,
    "url_extract_path": _varchar_fn,
    "url_extract_query": _varchar_fn,
    "url_extract_fragment": _varchar_fn,
    "url_extract_parameter": _varchar_fn,
    "url_encode": _varchar_fn, "url_decode": _varchar_fn,
    "translate": _varchar_fn,
    "log": _double_fn,
    # arrays (operator/scalar/ArrayFunctions + ArraySubscript)
    "cardinality": _bigint_fn,
    "element_at": lambda n, a: _array_elem(n, a),
    "contains": lambda n, a: BOOLEAN,
    "array_position": _bigint_fn,
    "array_min": lambda n, a: _array_of(n, a).element,
    "array_max": lambda n, a: _array_of(n, a).element,
    "array_distinct": lambda n, a: _array_of(n, a),
    "array_sort": lambda n, a: _array_of(n, a),
    "array_join": _varchar_fn,
    "slice": lambda n, a: _array_of(n, a),
    "repeat": lambda n, a: _mk_array(a[0]),
    "sequence": lambda n, a: _mk_array(a[0]),
    "flatten": lambda n, a: _array_of(n, a).element,
    "arrays_overlap": lambda n, a: BOOLEAN,
    "array_union": lambda n, a: _common(n, a),
    "array_intersect": lambda n, a: _common(n, a),
    "array_except": lambda n, a: _common(n, a),
    # maps (operator/scalar/MapFunctions.java etc.)
    "map": lambda n, a: _map_ctor(n, a),
    "map_keys": lambda n, a: _mk_array(_map_of(n, a).key),
    "map_values": lambda n, a: _mk_array(_map_of(n, a).value),
    "map_concat": _common,
    "map_entries": lambda n, a: _map_entries(n, a),
    # HyperLogLog (operator/scalar/HyperLogLogFunctions.java)
    "empty_approx_set": lambda n, a: _hll_type(),
    # JSON (operator/scalar/JsonFunctions.java)
    "json_extract_scalar": _varchar_fn,
    "json_extract": _varchar_fn,
    "json_array_length": _bigint_fn,
    "json_size": _bigint_fn,
    "json_format": _varchar_fn,
    "json_parse": _varchar_fn,
    # HMAC + binary (HmacFunctions.java / VarbinaryFunctions.java;
    # varbinary is carried as a dictionary column like varchar)
    "hmac_md5": _varbinary_fn, "hmac_sha1": _varbinary_fn,
    "hmac_sha256": _varbinary_fn, "hmac_sha512": _varbinary_fn,
    "to_utf8": _varbinary_fn,
    "from_utf8": _varchar_fn,
    "to_big_endian_64": _varbinary_fn,
    "from_big_endian_64": _bigint_fn,
    "to_big_endian_32": _varbinary_fn,
    "from_big_endian_32": lambda n, a: INTEGER,
    "to_ieee754_64": _varbinary_fn,
    "from_ieee754_64": lambda n, a: DOUBLE,
    "to_ieee754_32": _varbinary_fn,
    "from_ieee754_32": lambda n, a: REAL,
    # ANSI bar charts (ColorFunctions.java; color type folded to varchar)
    "bar": _varchar_fn,
    "color": _varchar_fn,
    "render": _varchar_fn,
    # datetime extras (DateTimeFunctions.java joda-pattern entry points)
    "parse_datetime": lambda n, a: _tstz([TimestampType(3)]),
    "format_datetime": _varchar_fn,
    "from_iso8601_date": lambda n, a: DATE,
    "from_iso8601_timestamp": lambda n, a: _tstz([TimestampType(3)]),
    "last_day_of_month": lambda n, a: DATE,
    "timezone_hour": _bigint_fn,
    "timezone_minute": _bigint_fn,
    # similarity (ArrayFunctions / MathFunctions)
    "cosine_similarity": _double_fn_maps,
    "word_stem": _varchar_fn,
    # array extras
    "array_remove": lambda n, a: _array_of(n, a),
    "zip": _zip_type,
    "ngrams": lambda n, a: _mk_array(_array_of(n, a)),
    "combinations": lambda n, a: _mk_array(_array_of(n, a)),
    "array_last": lambda n, a: _array_of(n, a).element,
    "array_first": lambda n, a: _array_of(n, a).element,
    "map_from_entries": _map_from_entries_type,
    "multimap_from_entries": _multimap_from_entries_type,
    "split_to_multimap": lambda n, a: _split_to_multimap_type(),
    # quantile sketch accessors (TDigestFunctions/QuantileDigestFunctions)
    "value_at_quantile": _value_at_quantile_type,
    "values_at_quantiles": lambda n, a: _mk_array(
        _value_at_quantile_type(n, a)),
    "quantile_at_value": _double_fn_sketch,
}


def _hll_type():
    # matches approx_set's default bucket count so empty_approx_set()
    # merges with approx_set(x) sketches (APPROX_SET_BUCKET_BITS)
    from .types import HyperLogLogType
    from .ops.hll import APPROX_SET_BUCKET_BITS
    return HyperLogLogType(APPROX_SET_BUCKET_BITS)


def _array_elem(name, args):
    from .types import ArrayType, MapType
    if args and isinstance(args[0], MapType):
        return args[0].value
    if not args or not isinstance(args[0], ArrayType):
        raise FunctionResolutionError(
            f"{name} requires an array argument")
    return args[0].element


def _array_of(name, args):
    from .types import ArrayType
    if not args or not isinstance(args[0], ArrayType):
        raise FunctionResolutionError(f"{name} requires an array")
    return args[0]


def _map_of(name, args):
    from .types import MapType
    if not args or not isinstance(args[0], MapType):
        raise FunctionResolutionError(f"{name} requires a map")
    return args[0]


def _mk_array(t):
    from .types import ArrayType
    return ArrayType(t)


def _time_type():
    from .types import TimeType
    return TimeType(3)


def _tstz(args):
    from .types import TimestampTZType
    p = getattr(args[0], "precision", 3) if args else 3
    return TimestampTZType(p)


def _split_to_map_type():
    from .types import MapType
    return MapType(VARCHAR, VARCHAR)


def _map_ctor(name, args):
    from .types import ArrayType, MapType
    if (len(args) != 2 or not isinstance(args[0], ArrayType)
            or not isinstance(args[1], ArrayType)):
        raise FunctionResolutionError(
            "map() takes two array arguments (keys, values)")
    return MapType(args[0].element, args[1].element)


def _map_entries(name, args):
    from .types import ArrayType, RowType
    m = _map_of(name, args)
    return ArrayType(RowType([("key", m.key), ("value", m.value)]))


def _err(name, args):
    raise FunctionResolutionError(
        f"{name}({', '.join(str(a) for a in args)}) not supported")


def is_aggregate(name: str) -> bool:
    return name in AGGREGATE_NAMES or name == "count"


def is_window(name: str) -> bool:
    return name in WINDOW_ONLY_NAMES


def scalar_result_type(name: str, arg_types: Sequence[Type]) -> Type:
    fn = _SCALARS.get(name)
    if fn is None:
        raise FunctionResolutionError(f"Function '{name}' not registered")
    return fn(name, list(arg_types))


def list_functions() -> List[str]:
    return sorted(set(_SCALARS) | AGGREGATE_NAMES | WINDOW_ONLY_NAMES
                  | {"count"})
