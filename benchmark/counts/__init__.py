"""Operations and bytes of the work a cell asks for, from shapes alone:
the same whatever route or kernel implements the work."""
