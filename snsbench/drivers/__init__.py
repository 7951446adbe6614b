"""Entry points of the program that a traffic mix drives, one module a
driver (see ``resident.py`` for what a driver provides)."""
