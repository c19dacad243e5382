"""Model families (the dense decoder so far) and their building blocks."""
