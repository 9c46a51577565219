"""The entries a cell's window can drive, one module each, named by the
traffic mix's ``entry``: ``setup()``, ``step()`` (one unit of the
end-to-end metric ``e2e``), ``close()`` and ``check()`` (the numbers the
comparison judges)."""
