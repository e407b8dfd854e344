"""The traffic kinds; a traffic file's ``kind`` names one module here."""
