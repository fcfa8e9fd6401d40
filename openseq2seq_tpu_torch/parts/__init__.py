from .initializers import resolve_initializer
