"""The plain references the benchmark judges the program against, and the
work a flush must do at the least.  Nothing here imports the program."""
