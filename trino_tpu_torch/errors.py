"""Error taxonomy: StandardErrorCode and ErrorType.

Counterpart of ``trino_tpu/errors.py`` (host only). The client protocol
and the tests key off these names and codes, so the numbering is
Trino's (StandardErrorCode.java ordinals; INTERNAL_ERROR at 0x10000,
INSUFFICIENT_RESOURCES at 0x20000, EXTERNAL at 0x1000000).
"""

from __future__ import annotations

from typing import Optional, Tuple

USER_ERROR = "USER_ERROR"
INTERNAL_ERROR = "INTERNAL_ERROR"
INSUFFICIENT_RESOURCES = "INSUFFICIENT_RESOURCES"
EXTERNAL = "EXTERNAL"

_INTERNAL_BASE = 0x0001_0000
_INSUFFICIENT_BASE = 0x0002_0000
_EXTERNAL_BASE = 0x0100_0000

# name -> (code, type). USER_ERROR block is 0-based, INTERNAL 0x10000,
# INSUFFICIENT_RESOURCES 0x20000 (StandardErrorCode.java ordinals).
STANDARD_ERROR_CODES = {
    # user errors (StandardErrorCode.java:20-90)
    "GENERIC_USER_ERROR": (0, USER_ERROR),
    "SYNTAX_ERROR": (1, USER_ERROR),
    "ABANDONED_QUERY": (2, USER_ERROR),
    "USER_CANCELED": (3, USER_ERROR),
    "PERMISSION_DENIED": (4, USER_ERROR),
    "NOT_FOUND": (5, USER_ERROR),
    "FUNCTION_NOT_FOUND": (6, USER_ERROR),
    "INVALID_FUNCTION_ARGUMENT": (7, USER_ERROR),
    "DIVISION_BY_ZERO": (8, USER_ERROR),
    "INVALID_CAST_ARGUMENT": (9, USER_ERROR),
    "OPERATOR_NOT_FOUND": (10, USER_ERROR),
    "INVALID_VIEW": (11, USER_ERROR),
    "ALREADY_EXISTS": (12, USER_ERROR),
    "NOT_SUPPORTED": (13, USER_ERROR),
    "INVALID_SESSION_PROPERTY": (14, USER_ERROR),
    "INVALID_WINDOW_FRAME": (15, USER_ERROR),
    "CONSTRAINT_VIOLATION": (16, USER_ERROR),
    "TRANSACTION_CONFLICT": (17, USER_ERROR),
    "INVALID_TABLE_PROPERTY": (18, USER_ERROR),
    "NUMERIC_VALUE_OUT_OF_RANGE": (19, USER_ERROR),
    "UNKNOWN_TRANSACTION": (20, USER_ERROR),
    "NOT_IN_TRANSACTION": (21, USER_ERROR),
    "TRANSACTION_ALREADY_ABORTED": (22, USER_ERROR),
    "READ_ONLY_VIOLATION": (23, USER_ERROR),
    "MULTI_CATALOG_WRITE_CONFLICT": (24, USER_ERROR),
    "AUTOCOMMIT_WRITE_CONFLICT": (25, USER_ERROR),
    "UNSUPPORTED_ISOLATION_LEVEL": (26, USER_ERROR),
    "INCOMPATIBLE_CLIENT": (27, USER_ERROR),
    "SUBQUERY_MULTIPLE_ROWS": (28, USER_ERROR),
    "PROCEDURE_NOT_FOUND": (29, USER_ERROR),
    "INVALID_PROCEDURE_ARGUMENT": (30, USER_ERROR),
    "QUERY_REJECTED": (31, USER_ERROR),
    "AMBIGUOUS_FUNCTION_CALL": (32, USER_ERROR),
    "INVALID_SCHEMA_PROPERTY": (33, USER_ERROR),
    "SCHEMA_NOT_EMPTY": (34, USER_ERROR),
    "QUERY_TEXT_TOO_LARGE": (35, USER_ERROR),
    "UNSUPPORTED_SUBQUERY": (36, USER_ERROR),
    "EXCEEDED_FUNCTION_MEMORY_LIMIT": (37, USER_ERROR),
    "ADMINISTRATIVELY_KILLED": (38, USER_ERROR),
    "INVALID_COLUMN_PROPERTY": (39, USER_ERROR),
    "QUERY_HAS_TOO_MANY_STAGES": (40, USER_ERROR),
    "INVALID_SPATIAL_PARTITIONING": (41, USER_ERROR),
    "INVALID_ANALYZE_PROPERTY": (42, USER_ERROR),
    "TYPE_NOT_FOUND": (43, USER_ERROR),
    "CATALOG_NOT_FOUND": (44, USER_ERROR),
    "SCHEMA_NOT_FOUND": (45, USER_ERROR),
    "TABLE_NOT_FOUND": (46, USER_ERROR),
    "COLUMN_NOT_FOUND": (47, USER_ERROR),
    "ROLE_NOT_FOUND": (48, USER_ERROR),
    "SCHEMA_ALREADY_EXISTS": (49, USER_ERROR),
    "TABLE_ALREADY_EXISTS": (50, USER_ERROR),
    "COLUMN_ALREADY_EXISTS": (51, USER_ERROR),
    "ROLE_ALREADY_EXISTS": (52, USER_ERROR),
    "DUPLICATE_NAMED_QUERY": (53, USER_ERROR),
    "DUPLICATE_COLUMN_NAME": (54, USER_ERROR),
    "MISSING_COLUMN_NAME": (55, USER_ERROR),
    "MISSING_CATALOG_NAME": (56, USER_ERROR),
    "MISSING_SCHEMA_NAME": (57, USER_ERROR),
    "TYPE_MISMATCH": (58, USER_ERROR),
    "INVALID_LITERAL": (59, USER_ERROR),
    "COLUMN_TYPE_UNKNOWN": (60, USER_ERROR),
    "MISMATCHED_COLUMN_ALIASES": (61, USER_ERROR),
    "AMBIGUOUS_NAME": (62, USER_ERROR),
    "INVALID_COLUMN_REFERENCE": (63, USER_ERROR),
    "MISSING_GROUP_BY": (64, USER_ERROR),
    "MISSING_ORDER_BY": (65, USER_ERROR),
    "MISSING_OVER": (66, USER_ERROR),
    "NESTED_AGGREGATION": (67, USER_ERROR),
    "NESTED_WINDOW": (68, USER_ERROR),
    "EXPRESSION_NOT_IN_DISTINCT": (69, USER_ERROR),
    "TOO_MANY_GROUPING_SETS": (70, USER_ERROR),
    "FUNCTION_NOT_WINDOW": (71, USER_ERROR),
    "FUNCTION_NOT_AGGREGATE": (72, USER_ERROR),
    "EXPRESSION_NOT_AGGREGATE": (73, USER_ERROR),
    "EXPRESSION_NOT_SCALAR": (74, USER_ERROR),
    "EXPRESSION_NOT_CONSTANT": (75, USER_ERROR),
    "INVALID_ARGUMENTS": (76, USER_ERROR),
    "TOO_MANY_ARGUMENTS": (77, USER_ERROR),
    "INVALID_PRIVILEGE": (78, USER_ERROR),
    "DUPLICATE_PROPERTY": (79, USER_ERROR),
    "INVALID_PARAMETER_USAGE": (80, USER_ERROR),
    "VIEW_IS_STALE": (81, USER_ERROR),
    "VIEW_IS_RECURSIVE": (82, USER_ERROR),
    "NULL_TREATMENT_NOT_ALLOWED": (83, USER_ERROR),
    "INVALID_ROW_FILTER": (84, USER_ERROR),
    "INVALID_COLUMN_MASK": (85, USER_ERROR),
    "MISSING_TABLE": (86, USER_ERROR),
    "INVALID_RECURSIVE_REFERENCE": (87, USER_ERROR),
    "MISSING_COLUMN_ALIASES": (88, USER_ERROR),
    "NESTED_RECURSIVE": (89, USER_ERROR),
    # internal errors (0x0001_0000 block)
    "GENERIC_INTERNAL_ERROR": (_INTERNAL_BASE + 0, INTERNAL_ERROR),
    "TOO_MANY_REQUESTS_FAILED": (_INTERNAL_BASE + 1, INTERNAL_ERROR),
    "PAGE_TOO_LARGE": (_INTERNAL_BASE + 2, INTERNAL_ERROR),
    "PAGE_TRANSPORT_ERROR": (_INTERNAL_BASE + 3, INTERNAL_ERROR),
    "PAGE_TRANSPORT_TIMEOUT": (_INTERNAL_BASE + 4, INTERNAL_ERROR),
    "NO_NODES_AVAILABLE": (_INTERNAL_BASE + 5, INTERNAL_ERROR),
    "REMOTE_TASK_ERROR": (_INTERNAL_BASE + 6, INTERNAL_ERROR),
    "COMPILER_ERROR": (_INTERNAL_BASE + 7, INTERNAL_ERROR),
    "REMOTE_TASK_MISMATCH": (_INTERNAL_BASE + 8, INTERNAL_ERROR),
    "SERVER_SHUTTING_DOWN": (_INTERNAL_BASE + 9, INTERNAL_ERROR),
    "FUNCTION_IMPLEMENTATION_MISSING": (
        _INTERNAL_BASE + 10, INTERNAL_ERROR),
    "REMOTE_BUFFER_CLOSE_FAILED": (_INTERNAL_BASE + 11, INTERNAL_ERROR),
    "SERVER_STARTING_UP": (_INTERNAL_BASE + 12, INTERNAL_ERROR),
    "FUNCTION_IMPLEMENTATION_ERROR": (
        _INTERNAL_BASE + 13, INTERNAL_ERROR),
    "INVALID_PROCEDURE_DEFINITION": (
        _INTERNAL_BASE + 14, INTERNAL_ERROR),
    "PROCEDURE_CALL_FAILED": (_INTERNAL_BASE + 15, INTERNAL_ERROR),
    "AMBIGUOUS_FUNCTION_IMPLEMENTATION": (
        _INTERNAL_BASE + 16, INTERNAL_ERROR),
    "ABANDONED_TASK": (_INTERNAL_BASE + 17, INTERNAL_ERROR),
    "CORRUPT_SERIALIZED_IDENTITY": (_INTERNAL_BASE + 18, INTERNAL_ERROR),
    "CORRUPT_PAGE": (_INTERNAL_BASE + 19, INTERNAL_ERROR),
    "OPTIMIZER_TIMEOUT": (_INTERNAL_BASE + 20, INTERNAL_ERROR),
    "OUT_OF_SPILL_SPACE": (_INTERNAL_BASE + 21, INSUFFICIENT_RESOURCES),
    "REMOTE_HOST_GONE": (_INTERNAL_BASE + 22, INTERNAL_ERROR),
    "CONFIGURATION_INVALID": (_INTERNAL_BASE + 23, INTERNAL_ERROR),
    "CONFIGURATION_UNAVAILABLE": (_INTERNAL_BASE + 24, INTERNAL_ERROR),
    "INVALID_RESOURCE_GROUP": (_INTERNAL_BASE + 25, INTERNAL_ERROR),
    "SERIALIZATION_ERROR": (_INTERNAL_BASE + 26, INTERNAL_ERROR),
    "REMOTE_TASK_FAILED": (_INTERNAL_BASE + 27, INTERNAL_ERROR),
    "EXCHANGE_MANAGER_NOT_CONFIGURED": (
        _INTERNAL_BASE + 28, INTERNAL_ERROR),
    # insufficient resources (0x0002_0000 block)
    "GENERIC_INSUFFICIENT_RESOURCES": (
        _INSUFFICIENT_BASE + 0, INSUFFICIENT_RESOURCES),
    "EXCEEDED_GLOBAL_MEMORY_LIMIT": (
        _INSUFFICIENT_BASE + 1, INSUFFICIENT_RESOURCES),
    "QUERY_QUEUE_FULL": (_INSUFFICIENT_BASE + 2, INSUFFICIENT_RESOURCES),
    "EXCEEDED_TIME_LIMIT": (
        _INSUFFICIENT_BASE + 3, INSUFFICIENT_RESOURCES),
    "CLUSTER_OUT_OF_MEMORY": (
        _INSUFFICIENT_BASE + 4, INSUFFICIENT_RESOURCES),
    "EXCEEDED_CPU_LIMIT": (
        _INSUFFICIENT_BASE + 5, INSUFFICIENT_RESOURCES),
    "EXCEEDED_SPILL_LIMIT": (
        _INSUFFICIENT_BASE + 6, INSUFFICIENT_RESOURCES),
    "EXCEEDED_LOCAL_MEMORY_LIMIT": (
        _INSUFFICIENT_BASE + 7, INSUFFICIENT_RESOURCES),
    "ADMINISTRATIVELY_PREEMPTED": (
        _INSUFFICIENT_BASE + 8, INSUFFICIENT_RESOURCES),
    "EXCEEDED_SCAN_LIMIT": (
        _INSUFFICIENT_BASE + 9, INSUFFICIENT_RESOURCES),
    # external
    "GENERIC_EXTERNAL": (_EXTERNAL_BASE + 0, EXTERNAL),
}


def error_info(name: str) -> Tuple[int, str]:
    return STANDARD_ERROR_CODES.get(
        name, STANDARD_ERROR_CODES["GENERIC_INTERNAL_ERROR"])


def http_status_for(error_type: str) -> int:
    """HTTP status for a non-protocol error surface (the statement
    protocol itself always carries errors in a 200 QueryResults
    payload, like the reference). USER_ERROR maps to 400,
    INSUFFICIENT_RESOURCES to 429 (the governance layer's admission
    rejections and memory kills are back-pressure, not server bugs —
    a bare 500 would make clients treat "queue full" as an outage),
    everything else stays 500."""
    if error_type == USER_ERROR:
        return 400
    if error_type == INSUFFICIENT_RESOURCES:
        return 429
    return 500


def classify(exc: BaseException) -> Tuple[str, int, str]:
    """(errorName, errorCode, errorType) for an engine exception —
    the coordinator's failure-info mapping (reference:
    util/Failures.java toFailure + ErrorCode)."""
    name = _name_for(exc)
    code, etype = error_info(name)
    return name, code, etype


def _name_for(exc: BaseException) -> str:
    explicit: Optional[str] = getattr(exc, "error_name", None)
    if explicit:
        return explicit
    cls = type(exc).__name__
    msg = str(exc)
    if cls == "ParseError" or msg.startswith("SYNTAX_ERROR"):
        return "SYNTAX_ERROR"
    if cls == "AccessDeniedError" or msg.startswith("Access Denied"):
        return "PERMISSION_DENIED"
    if cls in ("PlanningError", "FunctionResolutionError"):
        return "SYNTAX_ERROR"
    if cls == "NotImplementedError":
        return "NOT_SUPPORTED"
    low = msg.lower()
    if "does not exist" in low:
        if "table" in low or "view" in low:
            return "TABLE_NOT_FOUND"
        if "schema" in low:
            return "SCHEMA_NOT_FOUND"
        if "catalog" in low:
            return "CATALOG_NOT_FOUND"
        if "column" in low:
            return "COLUMN_NOT_FOUND"
        return "NOT_FOUND"
    if "already exists" in low:
        return "ALREADY_EXISTS"
    # governance errors (server/memory.py, server/resourcegroups.py):
    # BEFORE the "canceled" sniff — the killer's message says it
    # "canceled query X", which is a memory kill, not a user cancel —
    # and before the generic memory fallback
    if "cluster is out of memory" in low or "low-memory killer" in low:
        return "CLUSTER_OUT_OF_MEMORY"
    if "global memory limit" in low or "memory pool" in low:
        return "EXCEEDED_GLOBAL_MEMORY_LIMIT"
    if "maximum run time" in low or ("time limit" in low
                                     and "exceed" in low):
        return "EXCEEDED_TIME_LIMIT"
    if "canceled" in low:
        return "USER_CANCELED"
    if "division by zero" in low:
        return "DIVISION_BY_ZERO"
    if "memory" in low and ("exceed" in low or "limit" in low):
        return "EXCEEDED_LOCAL_MEMORY_LIMIT"
    if "queue" in low and "full" in low:
        return "QUERY_QUEUE_FULL"
    if cls == "QueryError":
        return "GENERIC_USER_ERROR"
    return "GENERIC_INTERNAL_ERROR"
