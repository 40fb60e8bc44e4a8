"""Plain reference of what the benchmark checks: a float32 MiniLM with
TF32 off, its own WordPiece and memex's window cut, and exact top-k over
the float32 rows. Imports torch and numpy only: nothing of the program."""
