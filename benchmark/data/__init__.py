"""The benchmark's generators: each configuration names one by its file."""
