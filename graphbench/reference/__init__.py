"""Plain references of the benchmark's programs (torch and numpy only;
nothing of the program under test)."""
