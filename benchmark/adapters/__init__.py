"""Adapters: one file per system under test, named by a configuration's
``adapter``."""
