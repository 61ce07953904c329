"""One adapter per kind of system a configuration names (``"system"``)."""
