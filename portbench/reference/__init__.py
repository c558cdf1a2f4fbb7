"""Plain references, one module a network; they import nothing of the
measured package."""
