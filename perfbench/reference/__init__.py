"""Plain references of the benchmark's cells. They import nothing of the
program under test: they get the benchmark's own weights and inputs and,
where a check follows the program frame by frame, its state as arrays."""
