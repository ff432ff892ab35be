"""Entries: how a request of a traffic mix drives the program, how the
reference judges the answers, and the control that stands in the
program's place.  A mix names its entry (``"entry"``); the module of that
name here provides ``run``, ``warm``, ``judge`` and ``control``."""
