"""The plain reference that decides ``correct``: NumPy and SciPy in float64
(``model.py``), the comparisons and their limits (``judge.py``). Nothing
here imports the port or JAX."""
