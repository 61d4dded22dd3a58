from .executor import Executor, QueryError  # noqa: F401
