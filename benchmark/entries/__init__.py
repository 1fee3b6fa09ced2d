"""Adapters from a configuration's ``entry`` to the program's entry point
and its plain reference (``reference/vplain``), one module each."""
