from .errors import handle_exception, swallow

__all__ = ["handle_exception", "swallow"]
