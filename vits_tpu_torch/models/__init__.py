"""models of the port (see vits_tpu_torch/__init__.py)."""
