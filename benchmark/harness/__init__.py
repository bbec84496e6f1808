"""The benchmark's harness: command line, result line, tracing, guard."""
