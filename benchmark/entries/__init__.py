"""The entry points a traffic mix names: ``decode`` and ``fit``."""
