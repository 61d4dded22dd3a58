"""SQL frontend: tokenizer → parser → AST → analyzer.

Reference parity: core/trino-parser (SqlBase.g4, AstBuilder.java,
SqlParser.java) and core/trino-main sql/analyzer. Re-implemented as a
hand-written recursive-descent parser rather than a generated one: the
grammar subset the engine executes is stable and a direct parser keeps
error messages precise with zero build-time tooling.
"""

from .parser import parse_statement  # noqa: F401
