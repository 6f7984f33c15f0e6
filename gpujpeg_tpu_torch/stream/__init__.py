"""stream subpackage."""
