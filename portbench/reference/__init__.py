"""The plain reference that decides ``correct``: numpy only, built from the
generator's arrays, importing nothing of the program."""

from .setgraph import SetGraph

__all__ = ["SetGraph"]
