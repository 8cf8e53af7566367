"""Command-line glue of the port (so far only the evaluation dispatch)."""
