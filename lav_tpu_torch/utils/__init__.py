"""Device selection, kernel build/load and weight conversion."""
