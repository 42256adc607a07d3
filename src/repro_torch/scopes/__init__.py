"""Builtin scopes of the torch port (see core.scope.BUILTIN_SCOPES)."""
