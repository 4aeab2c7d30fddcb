"""Plain operators of the frozen reference path."""
