"""Model configurations: ``base.py`` (the ModelConfig schema, input shapes)
and one file per architecture, registered in ``registry.py``."""
