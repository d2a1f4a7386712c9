"""The five raylint checkers (one module per rule)."""
