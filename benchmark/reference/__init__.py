"""Plain float32 references, one module per architecture, named by the
``reference`` key of a configuration file."""
