"""Plain float32 references of the benchmarked models. They import nothing
of the program under test."""
