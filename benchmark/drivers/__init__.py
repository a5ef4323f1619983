"""The benchmark's drivers: each traffic mix names one by its file."""
