from .reader import Histograms, SymbolReader  # noqa: F401
